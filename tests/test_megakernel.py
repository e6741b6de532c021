"""Megakernel tests: the Triton-route Pallas kernel in interpret mode
against its fused-XLA twin, the launcher's padding, and engine dispatch.
`chip_smoke.py` runs the compiled kernel on the card."""

import numpy as np
import pytest

import jax.numpy as jnp

import spira_tpu as st
from spira_tpu.core import pcg
from spira_tpu.kernels import megakernel as mk
from spira_tpu.kernels.megakernel import (
    render_flat_fused,
    render_flat_megakernel,
)
from spira_tpu.render import (
    ENGINE_TABLE,
    engine_row,
    render_flat,
    render_flat_engine,
    select_engine,
)


def test_pcg4d_uniformity_and_determinism():
    import jax.numpy as jnp

    pix = jnp.arange(1 << 14, dtype=jnp.uint32)
    u1 = pcg.uniform4(pix, 3, 7, 42)
    u2 = pcg.uniform4(pix, 3, 7, 42)
    for a, b in zip(u1, u2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a in u1:
        a = np.asarray(a)
        assert (a >= 0).all() and (a < 1).all()
        np.testing.assert_allclose(a.mean(), 0.5, atol=0.01)
        np.testing.assert_allclose(a.var(), 1 / 12, atol=0.01)
    # decorrelated across streams
    o1 = np.asarray(pcg.uniform4(pix, 3, 8, 42)[0])
    corr = np.corrcoef(np.asarray(u1[0]), o1)[0, 1]
    assert abs(corr) < 0.05


def test_box_muller_moments():
    import jax.numpy as jnp

    pix = jnp.arange(1 << 14, dtype=jnp.uint32)
    u1, u2, _, _ = pcg.uniform4(pix, 0, 0, 7)
    g1, g2 = pcg.box_muller(u1, u2)
    for g in (np.asarray(g1), np.asarray(g2)):
        np.testing.assert_allclose(g.mean(), 0.0, atol=0.03)
        np.testing.assert_allclose(g.std(), 1.0, atol=0.03)


@pytest.mark.slow
def test_megakernel_matches_xla_statistically():
    """The fused kernel implements the same physical estimator as the XLA
    wavefront path — means agree within MC noise."""
    scene = st.create_scene()
    cam = st.default_camera(2.0)
    mk = np.asarray(
        render_flat_megakernel(
            scene, cam, width=128, height=64, spp=24, max_depth=4, seed=0,
            interpret=True,
        )
    )
    xla = np.asarray(
        render_flat(scene, cam, width=128, height=64, spp=24, max_depth=4, seed=1)
    )
    assert abs(mk.mean() - xla.mean()) < 0.015
    assert np.abs(mk - xla).mean() < 0.06


def test_megakernel_deterministic_and_seed_sensitive():
    scene = st.create_scene()
    cam = st.default_camera(2.0)
    a = np.asarray(
        render_flat_megakernel(
            scene, cam, width=128, height=16, spp=2, max_depth=2, seed=5,
            interpret=True,
        )
    )
    b = np.asarray(
        render_flat_megakernel(
            scene, cam, width=128, height=16, spp=2, max_depth=2, seed=5,
            interpret=True,
        )
    )
    np.testing.assert_array_equal(a, b)
    c = np.asarray(
        render_flat_megakernel(
            scene, cam, width=128, height=16, spp=2, max_depth=2, seed=6,
            interpret=True,
        )
    )
    assert np.abs(a - c).max() > 0


def test_megakernel_rejects_large_triangle_scenes():
    scene = st.create_mesh_scene(subdivisions=1)  # hundreds of triangles
    cam = st.default_camera(1.0)
    with pytest.raises(ValueError):
        render_flat_megakernel(
            scene, cam, width=128, height=8, spp=1, max_depth=1, interpret=True
        )


@pytest.mark.slow
def test_fused_triangles_match_wavefront():
    """Small-mesh fused tracing (static triangle unroll) agrees with the
    wavefront estimator — the Cornell box exercises quads + spheres."""
    from spira_tpu.kernels.megakernel import render_flat_fused

    scene = st.create_cornell_box()
    cam = st.cornell_camera(1.0)
    fz = np.asarray(
        render_flat_fused(scene, cam, width=32, height=32, spp=32, max_depth=4,
                          seed=0)
    )
    wf = np.asarray(
        render_flat(scene, cam, width=32, height=32, spp=32, max_depth=4,
                    seed=1)
    )
    wf2 = np.asarray(
        render_flat(scene, cam, width=32, height=32, spp=32, max_depth=4,
                    seed=2)
    )
    noise_floor = np.abs(wf - wf2).mean()  # wavefront-vs-wavefront MC noise
    assert abs(fz.mean() - wf.mean()) < 0.06
    assert np.abs(fz - wf).mean() < 1.2 * noise_floor


def test_fused_triangle_geometry_exact():
    """Primary-visibility check: a single bright emissive triangle renders
    in the same pixels in fused and wavefront engines."""
    tris = st.make_triangles(
        [[-0.5, -0.5, -2.0], [0.5, -0.5, -2.0], [0.0, 0.6, -2.0]],
        [[0, 1, 2]], 0,
    )
    mats = st.make_materials(
        [dict(albedo=(1.0, 1.0, 1.0), emission=(10.0, 10.0, 10.0))]
    )
    scene = st.make_scene(triangles=tris, materials=mats)
    cam = st.make_camera(lookfrom=(0, 0, 1), lookat=(0, 0, -2), vfov=60,
                         aspect_ratio=1.0)
    from spira_tpu.kernels.megakernel import render_flat_fused

    fz = np.asarray(
        render_flat_fused(scene, cam, width=48, height=48, spp=4, max_depth=1,
                          seed=0)
    ).reshape(48, 48, 3)
    wf = np.asarray(
        render_flat(scene, cam, width=48, height=48, spp=4, max_depth=1, seed=0)
    ).reshape(48, 48, 3)
    # emissive pixels (radiance > 5) must be the same set up to jitter noise
    a = fz.mean(-1) > 5
    b = wf.mean(-1) > 5
    assert (a == b).mean() > 0.97
    assert a.sum() > 50


@pytest.mark.slow
def test_megakernel_padding_tiles():
    """Non-multiple sizes: padded tiles must not corrupt the visible image."""
    scene = st.create_scene()
    cam = st.default_camera(100 / 30)
    mk = np.asarray(
        render_flat_megakernel(
            scene, cam, width=100, height=30, spp=4, max_depth=2, seed=0,
            interpret=True,
        )
    )
    assert mk.shape == (3000, 3)
    assert np.isfinite(mk).all()
    xla = np.asarray(
        render_flat(scene, cam, width=100, height=30, spp=4, max_depth=2, seed=1)
    )
    assert abs(mk.mean() - xla.mean()) < 0.05


@pytest.mark.slow
def test_fused_gradients_match_finite_differences():
    """The fused engine is differentiable (path-replay remat): check
    d(loss)/d(albedo) against central differences."""
    import jax
    import jax.numpy as jnp

    from spira_tpu.core.types import replace
    from spira_tpu.kernels.megakernel import render_flat_fused

    scene = st.create_scene()
    cam = st.default_camera(2.0)
    target = jnp.full((16 * 128, 3), 0.25, jnp.float32)

    def loss_from_albedo(albedo):
        mats = replace(scene.materials, albedo=albedo)
        img = render_flat_fused(
            replace(scene, materials=mats), cam, width=128, height=16,
            spp=2, max_depth=4, seed=5,
        )
        return jnp.mean((img - target) ** 2)

    loss_fn = jax.jit(loss_from_albedo)
    g = np.asarray(jax.jit(jax.grad(loss_from_albedo))(scene.materials.albedo))
    assert np.isfinite(g).all() and np.abs(g).max() > 0

    rs = np.random.default_rng(1)
    base = np.asarray(scene.materials.albedo, np.float64)
    for _ in range(4):
        i, j = rs.integers(base.shape[0]), rs.integers(3)
        eps = 2e-3
        ap, am = base.copy(), base.copy()
        ap[i, j] += eps
        am[i, j] -= eps
        fd = (
            float(loss_fn(jnp.asarray(ap, jnp.float32)))
            - float(loss_fn(jnp.asarray(am, jnp.float32)))
        ) / (2 * eps)
        assert abs(fd - g[i, j]) <= max(2e-3, 0.06 * abs(fd)), (
            f"albedo[{i},{j}] fd={fd:.6f} grad={g[i, j]:.6f}"
        )


def test_engine_dispatch():
    sphere_scene = st.create_scene()
    mesh_scene = st.create_mesh_scene(subdivisions=1)
    # CPU backend in tests → fused (not pallas)
    assert select_engine(sphere_scene, "physical", False) == "fused"
    assert select_engine(sphere_scene, "reference", False) == "wavefront"
    # spectral spheres route to the fused Chebyshev tracer since round 2
    assert select_engine(sphere_scene, "physical", True) == "fused"
    assert select_engine(mesh_scene, "physical", False) == "wavefront"
    assert select_engine(sphere_scene, "physical", False, "pallas") == "pallas"
    with pytest.raises(ValueError):
        select_engine(sphere_scene, "physical", False, "pallas_bvh")
    # the Triton kernel is RGB-only: spectral small scenes stay fused
    with pytest.raises(ValueError):
        render_flat_engine(sphere_scene, st.default_camera(2.0), width=8,
                           height=4, spp=1, spectral=True, engine="pallas")


def test_engine_dispatch_tpu_branch():
    """The GPU row of the engine table: small scenes take the Triton-route
    kernel, everything else the wavefront."""
    assert select_engine(
        st.create_scene(), "physical", False, platform="gpu"
    ) == ENGINE_TABLE["gpu"]["small"]
    assert select_engine(
        st.create_mesh_scene(subdivisions=1), "physical", False,
        platform="gpu",
    ) == "wavefront"


_KINDS = {
    # kind: (scene factory, semantics, spectral, table column)
    "sphere": (st.create_scene, "physical", False, "small"),
    "small_tri": (st.create_cornell_box, "physical", False, "small"),
    "mesh": (lambda: st.create_mesh_scene(subdivisions=1), "physical", False,
             "general"),
    "spectral": (st.create_cornell_box, "physical", True, "small_spectral"),
    "reference": (st.create_scene, "reference", False, "general"),
}


@pytest.mark.parametrize("platform", sorted(ENGINE_TABLE))
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_engine_table_rows(platform, kind):
    make, semantics, spectral, column = _KINDS[kind]
    got = select_engine(make(), semantics, spectral, platform=platform)
    assert got == ENGINE_TABLE[platform][column]
    assert got in ("pallas", "fused", "wavefront")


def test_engine_table_refuses_unknown_platform():
    with pytest.raises(ValueError, match="no engine row"):
        engine_row("metal")
    with pytest.raises(ValueError):
        select_engine(st.create_scene(), "physical", False, platform="rocm")


@pytest.mark.slow
def test_render_api_engine_fused_matches_wavefront_statistically():
    scene = st.create_scene()
    cam = st.default_camera(2.0)
    a = np.asarray(
        st.render(scene, cam, 128, 64, samples_per_pixel=16, max_depth=4,
                  engine="fused")
    ).astype(np.float32)
    b = np.asarray(
        st.render(scene, cam, 128, 64, samples_per_pixel=16, max_depth=4,
                  engine="wavefront")
    ).astype(np.float32)
    assert np.abs(a - b).mean() / 255.0 < 0.04


def test_thin_lens_fused_matches_wavefront_dof():
    """VERDICT r3 item 7: thin-lens raygen in the fused engines.  A wide
    aperture blurs out-of-focus geometry identically (statistically) in the
    fused tracer and the wavefront engine, and defocus scenes no longer
    force the slow engine."""
    from spira_tpu.scene.camera import make_camera

    scene = st.create_scene()
    cam = make_camera(
        lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0),
        aspect_ratio=2.0, aperture=0.4, focus_dist=3.2,
    )
    assert cam.has_lens
    # dispatch: lens cameras stay on the fast engines now
    for platform in ENGINE_TABLE:
        assert select_engine(scene, "physical", False, platform=platform) in (
            "fused", "pallas"
        )

    kw = dict(width=64, height=32, spp=24, max_depth=3)
    fz = np.asarray(render_flat_fused(scene, cam, seed=0, **kw))
    wf1 = np.asarray(render_flat(scene, cam, seed=1, **kw))
    wf2 = np.asarray(render_flat(scene, cam, seed=2, **kw))
    noise_floor = np.abs(wf1 - wf2).mean()
    assert np.isfinite(fz).all()
    assert abs(fz.mean() - wf1.mean()) < 0.05
    assert np.abs(fz - wf1).mean() < 1.3 * noise_floor

    # the lens actually blurs: pinhole and wide-aperture images differ
    pin = make_camera(lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      aspect_ratio=2.0)
    fz_pin = np.asarray(render_flat_fused(scene, pin, seed=0, **kw))
    assert np.abs(fz - fz_pin).mean() > 1e-3


def test_pinhole_raygen_unchanged_by_lens_support():
    """lens support must not perturb pinhole streams: has_lens=False uses
    the exact 12-field raygen (image identical across the cam-packing
    change)."""
    scene = st.create_scene()
    cam = st.default_camera(2.0)
    assert not cam.has_lens
    img = np.asarray(render_flat_fused(scene, cam, width=32, height=16,
                                       spp=2, max_depth=2, seed=11))
    assert np.isfinite(img).all() and img.std() > 1e-3


# ----------------------------------------------------------------------------
# The Triton-route kernel (interpret mode) against its fused-XLA twin
# ----------------------------------------------------------------------------


def _lens_camera(aspect):
    return st.make_camera(
        lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0),
        aspect_ratio=aspect, aperture=0.4, focus_dist=3.2,
    )


_KERNEL_CASES = {
    # case: (scene factory, camera factory)
    "demo_spheres": (st.create_scene, st.default_camera),
    "cornell_triangles": (st.create_cornell_box, st.cornell_camera),
    "thin_lens": (st.create_scene, _lens_camera),
}


@pytest.mark.parametrize("case", sorted(_KERNEL_CASES))
def test_triton_kernel_matches_fused_twin(case):
    """Same tracer, same PCG stream, same pixel ids: the kernel and the
    fused twin agree to float rounding (the two compile the arithmetic
    separately, so a contracted multiply-add may differ in the last bit)."""
    make_scene, make_camera = _KERNEL_CASES[case]
    w, h = 32, 8
    kw = dict(width=w, height=h, spp=2, max_depth=2, seed=4)
    scene, cam = make_scene(), make_camera(w / h)
    got = np.asarray(render_flat_megakernel(scene, cam, interpret=True, **kw))
    want = np.asarray(render_flat_fused(scene, cam, **kw))
    assert got.shape == want.shape == (w * h, 3)
    assert np.isfinite(got).all() and want.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_triton_kernel_pads_and_crops_partial_blocks():
    """An image whose pixel count is not a multiple of the block: the tail
    block is padding, cropped away, and the visible pixels match."""
    w, h = 37, 11
    assert (w * h) % mk.BLOCK
    scene = st.create_scene()
    cam = st.default_camera(w / h)
    kw = dict(width=w, height=h, spp=2, max_depth=2, seed=9)
    got = np.asarray(render_flat_megakernel(scene, cam, interpret=True, **kw))
    want = np.asarray(render_flat_fused(scene, cam, **kw))
    assert got.shape == (w * h, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "shape, padded",
    [((4, 14), (4, 16)), ((5, 14), (8, 16)), ((0, 22), (1, 32)),
     ((12, 41), (16, 64))],
)
def test_pad_table_powers_of_two(shape, padded):
    """The Triton route loads only power-of-two shapes: the launcher pads
    every scene table with zero rows and columns, keeping the data."""
    table = jnp.arange(int(np.prod(shape)), dtype=jnp.float32).reshape(shape)
    out = np.asarray(mk.pad_table(table))
    assert out.shape == padded
    np.testing.assert_array_equal(out[: shape[0], : shape[1]], table)
    assert not out[shape[0]:].any() and not out[:, shape[1]:].any()
