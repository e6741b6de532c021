"""BVH builder + traversal tests.

The traversal is compared exhaustively against brute-force intersection —
the guard SURVEY.md §7 prescribes after the reference's own left-child-only
traversal bug (`/root/reference/examples/spira-metal-raytracer.jl:606`)."""

import jax.numpy as jnp
import numpy as np
import pytest

from spira_tpu.accel.bvh import (
    build_bvh,
    build_bvh_for_triangles,
    build_two_level,
    validate_bvh,
)
from spira_tpu.accel.traverse import intersect_bvh
from spira_tpu.core import vecmath as vm
from spira_tpu.integrator.intersect import intersect_triangles
from spira_tpu.scene.geometry import make_triangles, triangle_bounds
from spira_tpu.scene.obj import cube, icosphere


def random_soup(n, seed, spread=4.0):
    rs = np.random.default_rng(seed)
    v0 = rs.normal(size=(n, 3)) * spread
    v1 = v0 + rs.normal(size=(n, 3)) * 0.7
    v2 = v0 + rs.normal(size=(n, 3)) * 0.7
    verts = np.concatenate([v0, v1, v2]).astype(np.float32)
    faces = np.stack(
        [np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], axis=1
    )
    return make_triangles(verts, faces, np.arange(n) % 7)


def random_rays(n, seed, spread=6.0):
    rs = np.random.default_rng(seed)
    o = rs.normal(size=(n, 3)).astype(np.float32) * spread
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def assert_hits_match(bvh_hit, brute_hit, atol=1e-3):
    np.testing.assert_array_equal(
        np.asarray(bvh_hit.hit), np.asarray(brute_hit.hit)
    )
    m = np.asarray(brute_hit.hit)
    np.testing.assert_allclose(
        np.asarray(bvh_hit.t)[m], np.asarray(brute_hit.t)[m], rtol=2e-4,
        atol=atol,
    )
    np.testing.assert_array_equal(
        np.asarray(bvh_hit.material)[m], np.asarray(brute_hit.material)[m]
    )


def test_builder_invariants():
    tris = random_soup(500, seed=0)
    lo, hi = triangle_bounds(tris)
    bvh = build_bvh(lo, hi)
    validate_bvh(bvh, lo, hi)
    assert bvh.max_leaf <= 4


@pytest.mark.parametrize("n_tris,seed", [(1, 1), (5, 2), (64, 3), (517, 4)])
@pytest.mark.slow
def test_traversal_matches_brute_force(n_tris, seed):
    tris = random_soup(n_tris, seed)
    bvh = build_bvh_for_triangles(tris)
    o, d = random_rays(256, seed + 100)
    bvh_hit = intersect_bvh(bvh, tris, o, d)
    brute_hit = intersect_triangles(tris, o, d)
    assert_hits_match(bvh_hit, brute_hit)


@pytest.mark.slow
def test_traversal_icosphere_from_inside_and_outside():
    tris = icosphere(center=(0, 0, -3), radius=1.0, subdivisions=3)
    assert tris.count == 20 * 4**3
    bvh = build_bvh_for_triangles(tris)
    o, d = random_rays(512, seed=9, spread=3.0)
    assert_hits_match(
        intersect_bvh(bvh, tris, o, d), intersect_triangles(tris, o, d)
    )


@pytest.mark.slow
def test_two_level_matches_brute_force():
    meshes = [
        icosphere(center=(-2, 0, -4), radius=1.0, subdivisions=1),
        cube(center=(2, 0, -4), size=1.5),
        random_soup(33, seed=5, spread=1.0),
    ]
    bvh, tris = build_two_level(meshes)
    o, d = random_rays(400, seed=11)
    assert_hits_match(
        intersect_bvh(bvh, tris, o, d), intersect_triangles(tris, o, d)
    )


@pytest.mark.slow
def test_two_level_single_mesh():
    bvh, tris = build_two_level([cube(size=2.0)])
    o, d = random_rays(64, seed=12, spread=3.0)
    assert_hits_match(
        intersect_bvh(bvh, tris, o, d), intersect_triangles(tris, o, d)
    )


@pytest.mark.slow
def test_scene_with_bvh_renders_mesh():
    """End-to-end: a scene whose triangles route through the BVH must render
    identically (statistically) to brute force."""
    import spira_tpu as st
    from spira_tpu.render import render_flat

    tris = icosphere(center=(0, 0, 0), radius=0.6, subdivisions=2, material=0)
    mats = st.make_materials(
        [dict(albedo=(0.8, 0.3, 0.2), metallic=0.0, roughness=0.5)]
    )
    scene_brute = st.make_scene(triangles=tris, materials=mats)
    scene_bvh = scene_brute.with_bvh(build_bvh_for_triangles(tris))
    cam = st.make_camera(
        lookfrom=(0, 0.5, 2.5), lookat=(0, 0, 0), vfov=40.0, aspect_ratio=1.0
    )
    a = np.asarray(
        render_flat(scene_brute, cam, width=24, height=24, spp=4, max_depth=2, seed=3)
    )
    b = np.asarray(
        render_flat(scene_bvh, cam, width=24, height=24, spp=4, max_depth=2, seed=3)
    )
    # identical RNG + identical hits → identical images
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_native_sah_builder_matches_brute_force():
    """C++ binned-SAH builder (native/bvh_builder.cpp): invariants + exact
    traversal agreement with brute force; skipped when no toolchain."""
    from spira_tpu.accel.native import build_bvh_native, native_available

    if not native_available():
        pytest.skip("native builder unavailable")
    tris = random_soup(700, seed=21)
    lo, hi = triangle_bounds(tris)
    bvh = build_bvh_native(lo, hi)
    validate_bvh(bvh, lo, hi)
    o, d = random_rays(256, seed=22)
    assert_hits_match(
        intersect_bvh(bvh, tris, o, d), intersect_triangles(tris, o, d)
    )


def test_native_sah_quality_not_worse_than_median():
    """SAH trees should not have more nodes than median-split trees."""
    from spira_tpu.accel.native import build_bvh_native, native_available

    if not native_available():
        pytest.skip("native builder unavailable")
    tris = icosphere(subdivisions=4)
    lo, hi = triangle_bounds(tris)
    sah = build_bvh_native(lo, hi)
    med = build_bvh(lo, hi)
    assert sah.node_count <= med.node_count


@pytest.mark.slow
def test_stackless_equals_stack_traversal():
    """The production stackless traversal must agree exactly with the
    stack-per-ray oracle (and hence with brute force)."""
    from spira_tpu.accel.traverse import intersect_bvh_stack

    for n_tris, seed in [(5, 31), (64, 32), (700, 33)]:
        tris = random_soup(n_tris, seed)
        bvh = build_bvh_for_triangles(tris)
        o, d = random_rays(256, seed + 500)
        a = intersect_bvh(bvh, tris, o, d)
        b = intersect_bvh_stack(bvh, tris, o, d)
        np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
        m = np.asarray(a.hit)
        np.testing.assert_allclose(
            np.asarray(a.t)[m], np.asarray(b.t)[m], rtol=1e-6
        )
        np.testing.assert_array_equal(
            np.asarray(a.material)[m], np.asarray(b.material)[m]
        )


@pytest.mark.slow
def test_stackless_two_level_with_redirects():
    meshes = [
        icosphere(center=(-2, 0, -4), radius=1.0, subdivisions=2),
        cube(center=(2, 0, -4), size=1.5),
    ]
    bvh, tris = build_two_level(meshes)
    o, d = random_rays(300, seed=41)
    assert_hits_match(
        intersect_bvh(bvh, tris, o, d), intersect_triangles(tris, o, d)
    )


# ----------------------------------------------------------------------------
# Mixed sphere+triangle BVH (typed prim ids — reference flat BVH v1,
# /root/reference/examples/julia-raytracer-optimized.jl:1232-1324)
# ----------------------------------------------------------------------------

def random_spheres(n, seed, spread=4.0):
    from spira_tpu.scene.geometry import make_spheres

    rs = np.random.default_rng(seed)
    recs = [
        (tuple(rs.normal(size=3) * spread), abs(rs.normal()) * 0.8 + 0.2,
         int(rs.integers(0, 7)))
        for _ in range(n)
    ]
    return make_spheres(recs)


@pytest.mark.parametrize(
    "n_sph,n_tris,seed", [(1, 0, 5), (9, 0, 6), (5, 40, 7), (60, 200, 8)]
)
@pytest.mark.slow
def test_mixed_traversal_matches_brute_force(n_sph, n_tris, seed):
    from spira_tpu.accel.bvh import build_mixed_bvh
    from spira_tpu.accel.traverse import intersect_bvh_mixed
    from spira_tpu.integrator.intersect import (
        intersect_spheres,
        merge_hits,
    )

    spheres = random_spheres(n_sph, seed)
    tris = random_soup(n_tris, seed + 50) if n_tris else None
    bvh = build_mixed_bvh(spheres, tris)
    o, d = random_rays(256, seed + 100)
    mixed = intersect_bvh_mixed(bvh, spheres, tris, o, d)

    brute = intersect_spheres(spheres, o, d)
    if n_tris:
        brute = merge_hits(brute, intersect_triangles(tris, o, d))
    assert_hits_match(mixed, brute)
    # normals agree too (sphere + triangle branches both resolve)
    m = np.asarray(brute.hit)
    np.testing.assert_allclose(
        np.asarray(mixed.normal)[m], np.asarray(brute.normal)[m], atol=2e-3
    )


def test_mixed_bvh_through_intersect_scene():
    """A scene whose bvh carries n_sph > 0 routes intersect_scene through
    the single mixed traversal; image-level hits match the brute path."""
    from spira_tpu.accel.bvh import build_mixed_bvh
    from spira_tpu.integrator.intersect import intersect_scene
    from spira_tpu.scene.scene import create_scene
    from spira_tpu.core.types import replace

    scene = create_scene()
    mixed_scene = replace(
        scene, bvh=build_mixed_bvh(scene.spheres, scene.triangles)
    )
    o, d = random_rays(512, 11)
    a = intersect_scene(scene, o, d)
    b = intersect_scene(mixed_scene, o, d)
    assert_hits_match(b, a)


def test_sbvh_spatial_splits_nearest_hit_parity():
    """SBVH (spatial splits, duplicated clipped references) finds exactly
    the same nearest hits as the plain SAH tree: traversal consumers must
    tolerate duplicate prim_idx entries and reference counts > n_tris."""
    import numpy as np

    from spira_tpu.accel.bvh import (
        build_bvh_for_triangles,
        build_sbvh_for_triangles,
    )
    from spira_tpu.accel.pairs import pack_bvh, traverse_packed_numpy
    from spira_tpu.scene.scene import create_mesh_scene

    tris = create_mesh_scene(subdivisions=2).triangles
    plain = pack_bvh(build_bvh_for_triangles(tris, leaf_size=4), tris)
    sbvh_tree = build_sbvh_for_triangles(tris, leaf_size=4)
    sbvh = pack_bvh(sbvh_tree, tris)
    assert sbvh_tree.prim_idx.shape[0] >= tris.count  # refs may duplicate

    rng = np.random.default_rng(7)
    # aim half the rays at the mesh (unit-scale icosphere at the origin)
    o = rng.uniform(-2.0, 2.0, (64, 3))
    d = rng.normal(size=(64, 3))
    d[::2] = rng.uniform(-0.6, 0.6, (32, 3)) - o[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hits = 0
    for i in range(64):
        t1, _, m1 = traverse_packed_numpy(plain, o[i], d[i])
        t2, _, m2 = traverse_packed_numpy(sbvh, o[i], d[i])
        if np.isfinite(t1):
            hits += 1
            assert abs(t1 - t2) < 1e-6 and m1 == m2, (i, t1, t2, m1, m2)
        else:
            assert not np.isfinite(t2), (i, t2)
    assert hits > 10  # the ray set actually exercises geometry


def test_row_granular_sah_parity_and_fill():
    """Row-granular SAH (row_size=8) finds the same nearest hits as the
    per-primitive SAH tree while packing leaves fuller (a traversal that
    pays one fixed 8-triangle row per leaf visit makes fill == fewer
    visits)."""
    import numpy as np

    from spira_tpu.accel.bvh import build_bvh_for_triangles
    from spira_tpu.accel.native import native_available
    from spira_tpu.accel.pairs import pack_bvh, traverse_packed_numpy
    from spira_tpu.scene.scene import create_mesh_scene

    if not native_available():
        import pytest

        pytest.skip("native builder unavailable")

    tris = create_mesh_scene(subdivisions=3).triangles
    plain_tree = build_bvh_for_triangles(tris, leaf_size=8, row_size=0)
    row_tree = build_bvh_for_triangles(tris, leaf_size=8, row_size=8)

    def leaf_stats(tree):
        is_leaf = np.asarray(tree.is_leaf) == 1
        cnt = np.asarray(tree.right)[is_leaf]
        return cnt.size, float(cnt.mean())

    n_plain, fill_plain = leaf_stats(plain_tree)
    n_row, fill_row = leaf_stats(row_tree)
    assert fill_row > fill_plain  # fuller leaves...
    assert n_row < n_plain  # ...hence fewer of them
    assert int(np.asarray(row_tree.right)[
        np.asarray(row_tree.is_leaf) == 1].max()) <= 8  # cap holds

    plain = pack_bvh(plain_tree, tris)
    rowp = pack_bvh(row_tree, tris)
    rng = np.random.default_rng(3)
    o = rng.uniform(-2.0, 2.0, (64, 3))
    d = rng.normal(size=(64, 3))
    d[::2] = rng.uniform(-0.6, 0.6, (32, 3)) - o[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hits = 0
    for i in range(64):
        t1, _, m1 = traverse_packed_numpy(plain, o[i], d[i])
        t2, _, m2 = traverse_packed_numpy(rowp, o[i], d[i])
        if np.isfinite(t1):
            hits += 1
            assert abs(t1 - t2) < 1e-6 and m1 == m2, (i, t1, t2, m1, m2)
        else:
            assert not np.isfinite(t2), (i, t2)
    assert hits > 10
