import numpy as np
import pytest

from spira_tpu.scene.obj import (
    cube,
    icosphere,
    load_obj_mesh,
    parse_obj,
    transform_vertices,
)

CUBE_OBJ = """
# simple cube
v -1 -1 -1
v 1 -1 -1
v 1 1 -1
v -1 1 -1
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
f 1 4 3 2
f 5 6 7 8
f 1 2 6 5
f 3 4 8 7
f 1 5 8 4
f 2 3 7 6
"""


def test_parse_obj_fan_triangulation():
    verts, faces = parse_obj(CUBE_OBJ)
    assert verts.shape == (8, 3)
    assert faces.shape == (12, 3)  # 6 quads -> 12 tris


def test_parse_obj_slash_formats_and_negative_indices():
    text = "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1/1 2/2/2 3//3\nf -3 -2 -1\n"
    verts, faces = parse_obj(text)
    assert faces.shape == (2, 3)
    np.testing.assert_array_equal(faces[0], [0, 1, 2])
    np.testing.assert_array_equal(faces[1], [0, 1, 2])


def test_parse_obj_empty_raises():
    with pytest.raises(ValueError):
        parse_obj("# nothing here\n")


def test_transform_pipeline():
    v = np.asarray([[0, 0, 0], [2, 0, 0], [0, 4, 0]], np.float32)
    out = transform_vertices(
        v, center=True, normalize=True, scale=2.0, translate=(10, 0, 0)
    )
    # normalized to unit radius then doubled: max |v - (10,0,0)| == 2
    r = np.linalg.norm(out - [10, 0, 0], axis=1).max()
    np.testing.assert_allclose(r, 2.0, rtol=1e-5)
    # centered: centroid at translate target
    np.testing.assert_allclose(out.mean(axis=0), [10, 0, 0], atol=1e-5)


def test_transform_rotation_orthogonal():
    v = np.eye(3, dtype=np.float32)
    out = transform_vertices(
        v, center=False, normalize=False, rotate_xyz=(30, 45, 60)
    )
    # rotation preserves pairwise distances
    d_in = np.linalg.norm(v[:, None] - v[None], axis=-1)
    d_out = np.linalg.norm(out[:, None] - out[None], axis=-1)
    np.testing.assert_allclose(d_in, d_out, rtol=1e-5)


def test_load_obj_mesh_roundtrip(tmp_path):
    p = tmp_path / "cube.obj"
    p.write_text(CUBE_OBJ)
    tris = load_obj_mesh(str(p), material=3, normalize=False, center=False)
    assert tris.count == 12
    assert int(tris.material[0]) == 3
    # all normals unit
    n = np.asarray(tris.normal)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, rtol=1e-5)


def test_icosphere_counts_and_radius():
    tris = icosphere(center=(1, 2, 3), radius=2.0, subdivisions=2)
    assert tris.count == 20 * 4**2
    v0 = np.asarray(tris.v0) - [1, 2, 3]
    np.testing.assert_allclose(np.linalg.norm(v0, axis=1), 2.0, rtol=1e-5)


def test_cube_winding_outward():
    tris = cube(size=2.0)
    # each face normal should point away from the center
    c = np.asarray(tris.v0) + (np.asarray(tris.e1) + np.asarray(tris.e2)) / 3
    n = np.asarray(tris.normal)
    assert (np.sum(c * n, axis=1) > 0).all()


def test_vendored_obj_through_two_level_bvh_and_packet_kernel():
    """A real on-disk OBJ (assets/trefoil.obj: 1152 quad faces, v//vn
    syntax) through the full bunny-tier path: parse -> fan triangulation ->
    two-level BVH -> the stackless XLA walk, whose nearest hits must equal
    brute force over every triangle.  This is the reference's Pkg test
    shape (/root/reference/tests/bunny-test.jl:9-44) with a vendored
    fixture instead of the network download."""
    import os

    import jax.numpy as jnp
    import numpy as np

    from spira_tpu.accel.traverse import intersect_bvh
    from spira_tpu.integrator.intersect import intersect_triangles
    from spira_tpu.scene.bunny import create_bunny_scene

    path = os.path.join(os.path.dirname(__file__), "..", "assets",
                        "trefoil.obj")
    scene, info = create_bunny_scene(obj_path=path)
    assert info["source"] != "procedural"
    assert info["triangles"] == 2 * 1152  # fan-triangulated quads
    assert info["builder"] in ("native-sah", "numpy-median")

    rng = np.random.default_rng(3)
    origins = jnp.asarray(rng.uniform(-1.5, 1.5, (512, 3)), jnp.float32)
    target = rng.uniform(-0.3, 0.6, (512, 3))
    dirs = target - np.asarray(origins)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs = jnp.asarray(dirs, jnp.float32)
    got = intersect_bvh(scene.bvh, scene.triangles, origins, dirs)
    want = intersect_triangles(scene.triangles, origins, dirs)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    hit = np.asarray(want.hit)
    assert hit.mean() > 0.1  # the rays aim at the mesh
    np.testing.assert_allclose(np.asarray(got.t)[hit],
                               np.asarray(want.t)[hit], rtol=1e-5)


def test_native_obj_parser_matches_python():
    """The C++ OBJ parser (native/obj_loader.cpp) is value-exact with the
    Python oracle on the vendored fixture and on a corner-case snippet
    (n-gon fan triangulation, negative indices, v//vn tokens)."""
    import os

    import numpy as np

    from spira_tpu.accel.native import parse_obj_native
    from spira_tpu.scene.obj import parse_obj

    snippet = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
f 1//1 2//1 3//1 4//1
f -4/-0/1 -3 -1
"""
    # normalize the weird vt token for the python parser too
    snippet = snippet.replace("-0/", "/")
    if parse_obj_native(snippet) is None:
        import pytest

        pytest.skip("native library unavailable")
    for text in [
        snippet,
        open(os.path.join(os.path.dirname(__file__), "..", "assets",
                          "trefoil.obj")).read(),
    ]:
        vn, fn = parse_obj_native(text)
        vp, fp = parse_obj(text, use_native=False)
        np.testing.assert_array_equal(vn, vp)
        np.testing.assert_array_equal(fn, fp)
