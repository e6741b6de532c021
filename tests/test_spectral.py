"""Spectral subsystem tests: colorimetry, hero-wavelength estimator,
dielectric + dispersion, Cornell box (BASELINE.json config 2)."""

import jax.numpy as jnp
import numpy as np
import pytest

import spira_tpu as st
from spira_tpu.core import colorimetry as cl
from spira_tpu.core import rng as srng
from spira_tpu.integrator.spectral import sample_wavelengths, trace_spectral
from spira_tpu.render import render_flat
from spira_tpu.scene.camera import generate_rays


def test_cmf_peaks_and_positivity():
    lam = jnp.linspace(cl.LAMBDA_MIN, cl.LAMBDA_MAX, 351)
    cmf = np.asarray(cl.cmf_xyz(lam))
    # y-bar peaks near 555 nm with value ~1
    peak = lam[np.argmax(cmf[:, 1])]
    assert 550 <= float(peak) <= 562
    assert 0.98 < cmf[:, 1].max() < 1.08
    # z-bar peaks near 445 nm
    peak_z = lam[np.argmax(cmf[:, 2])]
    assert 437 <= float(peak_z) <= 455
    assert float(np.asarray(cl.Y_INTEGRAL)) == pytest.approx(106.86, rel=0.01)


@pytest.mark.parametrize(
    "rgb,tol",
    [
        ((1.0, 1.0, 1.0), 0.02),
        ((0.7, 0.3, 0.3), 0.03),
        ((0.5, 0.5, 0.5), 0.02),
        ((0.8, 0.8, 1.0), 0.03),
        ((0.12, 0.45, 0.15), 0.05),
    ],
)
def test_smits_round_trip(rgb, tol):
    spd = cl.rgb_to_spd(np.asarray([rgb]))
    lam = np.linspace(cl.LAMBDA_MIN, cl.LAMBDA_MAX, 2048)
    vals = np.interp(lam, cl.SPD_GRID, spd[0])
    xyz = cl.spectrum_to_xyz(
        jnp.asarray(vals)[None, :], jnp.asarray(lam)[None, :]
    )
    back = np.asarray(cl.xyz_to_rgb(xyz))[0]
    np.testing.assert_allclose(back, rgb, atol=tol)


def test_sample_spd_interpolation():
    table = jnp.asarray([[0.0, 1.0, 0.0, 1.0] * 6], jnp.float32)  # (1, 24)
    mid = (cl.SPD_GRID[0] + cl.SPD_GRID[1]) / 2
    v = cl.sample_spd(table, jnp.asarray([[float(mid)]]))
    np.testing.assert_allclose(float(v[0, 0]), 0.5, atol=1e-5)
    # endpoints clamp
    v2 = cl.sample_spd(table, jnp.asarray([[100.0], [10000.0]]))
    np.testing.assert_allclose(np.asarray(v2)[:, 0], [0.0, 1.0], atol=1e-6)


def test_wavelength_stratification():
    k = srng.sample_key(srng.base_key(0), 0)
    lam = np.asarray(sample_wavelengths(k, 4096))
    assert lam.shape == (4096, cl.N_WAVELENGTHS)
    assert (lam >= cl.LAMBDA_MIN).all() and (lam < cl.LAMBDA_MAX).all()
    # rotations are range/W apart modulo the range
    d = np.mod(lam[:, 1] - lam[:, 0], cl.LAMBDA_RANGE)
    np.testing.assert_allclose(d, cl.LAMBDA_RANGE / cl.N_WAVELENGTHS, atol=1e-3)
    # hero uniform: mean near range center
    np.testing.assert_allclose(
        lam.mean(), (cl.LAMBDA_MIN + cl.LAMBDA_MAX) / 2, atol=3.0
    )


def test_spectral_matches_rgb_render_statistically():
    """An RGB-specified scene rendered spectrally must agree with the RGB
    estimator up to MC noise + Smits round-trip error."""
    scene = st.create_scene()
    cam = st.default_camera(32 / 18)
    spp = 48
    spec = np.asarray(
        render_flat(
            scene, cam, width=32, height=18, spp=spp, max_depth=4, seed=0,
            spectral=True,
        )
    )
    rgb = np.asarray(
        render_flat(scene, cam, width=32, height=18, spp=spp, max_depth=4, seed=1)
    )
    assert abs(spec.mean() - rgb.mean()) < 0.03
    assert np.abs(spec - rgb).mean() < 0.08


def test_dielectric_sphere_transmits():
    """A glass sphere in front of the light passes light through (physical
    semantics dielectric lobe)."""
    mats = st.make_materials(
        [
            dict(albedo=(1.0, 1.0, 1.0), metallic=1.0, roughness=0.0,
                 ior=1.5, transmission=1.0),
        ]
    )
    spheres = st.make_spheres([((0.0, 0.0, 0.0), 0.5, 0)])
    scene = st.make_scene(spheres=spheres, materials=mats)
    cam = st.make_camera(
        lookfrom=(0, 0, 2.0), lookat=(0, 0, 0), vfov=40, aspect_ratio=1.0
    )
    hdr = np.asarray(
        st.render_hdr(scene, cam, 24, 24, spp=16, max_depth=6, seed=2)
    )
    # center pixel sees through the sphere to the sky behind: must be bright
    assert hdr[12, 12].mean() > 0.4


@pytest.mark.slow
def test_dispersion_produces_chromatic_spread():
    """With cauchy_b > 0, refracted radiance becomes wavelength-dependent:
    the variance across color channels behind a prism-like sphere grows."""
    def glass_scene(b):
        mats = st.make_materials(
            [dict(albedo=(1.0, 1.0, 1.0), metallic=1.0, roughness=0.0,
                  ior=1.5, transmission=1.0, cauchy_b=b)]
        )
        spheres = st.make_spheres([((0.0, 0.0, 0.0), 0.5, 0)])
        return st.make_scene(spheres=spheres, materials=mats)

    cam = st.make_camera(
        lookfrom=(0, 0, 1.8), lookat=(0, 0, 0), vfov=45, aspect_ratio=1.0
    )

    def chroma(scene):
        hdr = np.asarray(
            st.render_hdr(
                scene, cam, 24, 24, spp=32, max_depth=6, seed=3, spectral=True
            )
        )
        return np.std(hdr, axis=-1).mean()

    c0 = chroma(glass_scene(0.0))
    c1 = chroma(glass_scene(0.02))
    assert c1 > c0 * 1.5, f"dispersion chroma {c0:.4f} -> {c1:.4f}"


@pytest.mark.slow
def test_cornell_box_renders(tmp_path):
    """BASELINE config 2: Cornell-style box, emissive + dielectric, spectral."""
    scene = st.create_cornell_box()
    cam = st.cornell_camera(1.0)
    img = st.render(
        scene, cam, 32, 32, samples_per_pixel=8, max_depth=5, spectral=True,
        tonemap="aces", output_path=str(tmp_path / "cornell.png"),
    )
    a = np.asarray(img, np.float32) / 255.0
    assert a.mean() > 0.05
    # red wall on the left, green wall on the right
    left = a[10:22, 2:7]
    right = a[10:22, 25:30]
    assert left[..., 0].mean() > left[..., 1].mean()
    assert right[..., 1].mean() > right[..., 0].mean()


@pytest.mark.slow
def test_spectral_gradients_flow_to_spd():
    """d(loss)/d(albedo_spd) is nonzero and finite — the inverse-spectral
    pathway of BASELINE config 4."""
    import jax

    from spira_tpu.diff.inverse import mse_loss, render_for_grad

    scene = st.create_scene()
    cam = st.default_camera(16 / 9)
    target = jnp.zeros((16 * 9, 3), jnp.float32)

    def loss(spd):
        img = render_for_grad(
            {"albedo_spd": spd}, scene, cam, width=16, height=9, spp=2,
            max_depth=3, seed=0, spectral=True,
        )
        return mse_loss(img, target)

    g = jax.grad(loss)(scene.materials.albedo_spd)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0


@pytest.mark.slow
def test_fused_spectral_matches_wavefront():
    """The fused spectral engine (Chebyshev SPDs, PCG RNG) implements the
    same hero-wavelength estimator as the wavefront path."""
    from spira_tpu.kernels.spectral_fused import render_flat_fused_spectral

    scene = st.create_cornell_box()
    cam = st.cornell_camera(1.0)
    fz = np.asarray(
        render_flat_fused_spectral(
            scene, cam, width=24, height=24, spp=24, max_depth=4, seed=0
        )
    )
    wf1 = np.asarray(
        render_flat(scene, cam, width=24, height=24, spp=24, max_depth=4,
                    seed=1, spectral=True)
    )
    wf2 = np.asarray(
        render_flat(scene, cam, width=24, height=24, spp=24, max_depth=4,
                    seed=2, spectral=True)
    )
    noise_floor = np.abs(wf1 - wf2).mean()
    assert abs(fz.mean() - wf1.mean()) < 0.07
    assert np.abs(fz - wf1).mean() < 1.25 * noise_floor


@pytest.mark.slow
def test_fused_spectral_via_render_api():
    scene = st.create_scene()
    cam = st.default_camera(2.0)
    img = st.render(
        scene, cam, 32, 16, samples_per_pixel=4, max_depth=3, spectral=True,
        engine="fused",
    )
    assert img.shape == (16, 32, 3)
    a = np.asarray(img, np.float32) / 255.0
    assert 0.1 < a.mean() < 0.95


@pytest.mark.slow
def test_fused_spectral_spd_gradients():
    """Gradients flow to albedo_spd through the Chebyshev projection."""
    import jax

    from spira_tpu.core.types import replace as dc_replace
    from spira_tpu.kernels.spectral_fused import render_flat_fused_spectral

    scene = st.create_scene()
    cam = st.default_camera(2.0)

    def loss(spd):
        mats = dc_replace(scene.materials, albedo_spd=spd)
        img = render_flat_fused_spectral(
            dc_replace(scene, materials=mats), cam, width=32, height=8,
            spp=2, max_depth=3, seed=0,
        )
        return jnp.mean(img**2)

    g = np.asarray(jax.grad(loss)(scene.materials.albedo_spd))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0
