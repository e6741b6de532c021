"""Tiered smoke renders, mirroring the reference's test tiers (SURVEY.md §4:
tests/test-tiny.jl 128×72 spp=1 depth=1; tests/test-metal-optimized.jl
320×180 spp=4 depth=2)."""

import numpy as np
import pytest

import spira_tpu as st


@pytest.mark.parametrize("semantics", ["physical", "reference"])
def test_tiny_render(semantics):
    scene = st.create_scene()
    cam = st.default_camera(64 / 36)
    img = st.render(
        scene, cam, 64, 36, samples_per_pixel=1, max_depth=1, semantics=semantics
    )
    assert img.shape == (36, 64, 3)
    assert img.dtype == np.uint8
    a = np.asarray(img, np.float32) / 255.0
    assert 0.05 < a.mean() < 0.98
    assert a.std() > 0.01  # not a flat image


def test_quick_render_shape_and_determinism():
    scene = st.create_scene()
    cam = st.default_camera(96 / 54)
    h1 = np.asarray(st.render_hdr(scene, cam, 96, 54, spp=2, max_depth=2, seed=9))
    h2 = np.asarray(st.render_hdr(scene, cam, 96, 54, spp=2, max_depth=2, seed=9))
    np.testing.assert_array_equal(h1, h2)  # counter-based RNG: exact replay
    h3 = np.asarray(st.render_hdr(scene, cam, 96, 54, spp=2, max_depth=2, seed=10))
    assert np.abs(h1 - h3).max() > 0  # different seed differs


def test_sky_only_row_matches_gradient():
    """Top rows look at sky: renderer must reproduce the analytic gradient
    (`/root/reference/src/spira_path_trace_kernel.metal:196-199`)."""
    import jax.numpy as jnp

    from spira_tpu.integrator.bsdf import sky_color

    scene = st.create_scene()
    # camera looking straight up sees only sky + maybe the light sphere;
    # look away from everything instead
    cam = st.make_camera(
        lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 1.0, 10.0), vfov=40.0,
        aspect_ratio=2.0,
    )
    hdr = np.asarray(st.render_hdr(scene, cam, 32, 16, spp=4, max_depth=3))
    # every pixel should be pure sky: blue-ish gradient, b >= r
    assert (hdr[..., 2] >= hdr[..., 0] - 1e-5).all()
    # compare center pixel against analytic sky for its ray
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    expected = np.asarray(sky_color(d))[0]
    center = hdr[8, 16]
    np.testing.assert_allclose(center, expected, atol=0.05)


def test_emissive_sphere_brighter_than_sky():
    scene = st.create_scene()
    cam = st.make_camera(
        lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 5.0, 0.0), vfov=30.0,
        aspect_ratio=1.0,
    )
    hdr = np.asarray(st.render_hdr(scene, cam, 24, 24, spp=4, max_depth=2))
    center = hdr[12, 12].mean()
    assert center > 3.0  # emission = 5 on the light sphere


@pytest.mark.slow
def test_bunny_tier_mesh_scene_render():
    """The bunny-test.jl analogue: render the two-level-BVH mesh scene and
    assert shape + plausible content (SURVEY.md §4 tier)."""
    scene = st.create_mesh_scene(subdivisions=2)
    cam = st.make_camera(
        lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0), vfov=50.0,
        aspect_ratio=64 / 48,
    )
    img = st.render(scene, cam, 64, 48, samples_per_pixel=2, max_depth=3)
    assert img.shape == (48, 64, 3)
    a = np.asarray(img, np.float32) / 255.0
    assert 0.1 < a.mean() < 0.95
    # mesh occupies the center: center differs from sky at the top corner
    assert abs(a[24, 32].mean() - a[0, 0].mean()) > 0.02


def test_depth_of_field_blur_and_dispatch():
    """Thin-lens cameras must blur with aperture; since round 3 the fused
    engines sample the lens too, so dispatch keeps DOF scenes on the fast
    path."""
    from spira_tpu.render import select_engine

    scene = st.create_scene()
    sharp_cam = st.make_camera(
        lookfrom=(0, 0.5, 3), lookat=(0, 0, 0), vfov=45, aspect_ratio=2.0,
        aperture=0.0, focus_dist=3.0,
    )
    # focus far in front of the light so it lands well out of focus
    blur_cam = st.make_camera(
        lookfrom=(0, 1, 3), lookat=(0, 5, 0), vfov=30, aspect_ratio=2.0,
        aperture=1.0, focus_dist=1.0,
    )
    assert select_engine(scene, "physical", False) in (
        "fused", "pallas"
    )
    assert select_engine(scene, "physical", False) in (
        "fused", "pallas"
    )
    sharp_light_cam = st.make_camera(
        lookfrom=(0, 1, 3), lookat=(0, 5, 0), vfov=30, aspect_ratio=2.0,
        aperture=0.0,
    )
    sharp = np.asarray(
        st.render_hdr(scene, sharp_light_cam, 64, 32, spp=32, max_depth=2,
                      seed=4, engine="wavefront")
    )
    blur = np.asarray(
        st.render_hdr(scene, blur_cam, 64, 32, spp=32, max_depth=2, seed=4,
                      engine="wavefront")
    )
    # defocus spreads the bright emitter: the hot in-focus peak disappears
    assert (sharp.mean(-1) > 4).mean() > 0.1
    assert (blur.mean(-1) > 4).mean() < 0.02
    assert blur.max() < 0.8 * sharp.max()


def test_reference_api_aliases():
    """The reference package exports render_hybrid_gpu / render_with_cpu
    (/root/reference/src/SPIRA.jl:10-13); the aliases must render."""
    scene = st.create_scene()
    cam = st.default_camera(2.0)
    a = st.render_hybrid_gpu(scene, cam, 32, 16, samples_per_pixel=2,
                             max_depth=2)
    b = st.render_with_cpu(scene, cam, 32, 16, samples_per_pixel=2,
                           max_depth=2)
    assert a.shape == b.shape == (16, 32, 3)
    # reference semantics is darker on diffuse surfaces
    assert float(np.asarray(b, np.float32).mean()) <= float(
        np.asarray(a, np.float32).mean()
    )


def test_select_engine_no_device_sync():
    """Engine dispatch must be computable from static metadata alone: it runs
    per render call, and reading a traced value (the old
    `float(camera.lens_radius)`) would block on a device-to-host sync every
    call.  `jax.eval_shape` makes every array leaf abstract, so any
    concretization inside select_engine raises."""
    import jax
    import jax.numpy as jnp

    from spira_tpu.render import select_engine

    scene = st.create_scene()
    cam = st.default_camera(2.0)

    def dispatch_only(s, c):
        engine = select_engine(s, "physical", False, "auto")
        assert isinstance(engine, str)
        return jnp.zeros(())

    jax.eval_shape(dispatch_only, scene, cam)

    lens_cam = st.make_camera(
        lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0), aperture=0.2,
        aspect_ratio=2.0,
    )
    assert lens_cam.has_lens
    # dispatch stays sync-free for lens cameras too (has_lens is static
    # metadata) and keeps them on the fast engines
    jax.eval_shape(dispatch_only, scene, lens_cam)
    assert select_engine(scene, "physical", False, "auto") in (
        "fused", "pallas"
    )
