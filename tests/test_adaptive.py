"""Adaptive progressive sampling (pipeline.render_adaptive): rows stop
sampling once their pixels' luminance CI95 converges — a new-build
capability (the reference samples uniformly; SURVEY.md lists no adaptive
machinery).

Dense adaptivity: one row-set dispatch per round
(render.accumulate_row_set) over only the unconverged rows, padded to
powers of two so compile count is bounded."""

import numpy as np
import pytest

import jax.numpy as jnp

import spira_tpu as st
from spira_tpu.pipeline import render_adaptive
from spira_tpu.utils.config import RenderConfig


def _demo(w=96, h=64, spp=16):
    scene = st.create_scene()
    cam = st.default_camera(w / h)
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=3,
                       progress=False)
    return scene, cam, cfg


def test_adaptive_saves_samples_and_sky_rows_retire_first():
    scene, cam, cfg = _demo()
    img, stats = render_adaptive(scene, cam, cfg, tol=0.05, min_spp=4,
                                 chunk=4, return_stats=True)
    assert img.shape == (64, 96, 3)
    assert np.isfinite(img).all()
    assert stats["savings"] > 0.1  # the sky half of the frame converges fast
    spp = stats["spp_per_row"]  # top-down
    # gradient sky (top rows) needs fewer samples than the diffuse ground
    # + spheres (bottom rows)
    assert spp[:8].mean() < spp[-8:].mean()
    assert spp.min() >= 4 and spp.max() <= cfg.spp


def test_adaptive_is_deterministic():
    scene, cam, cfg = _demo(w=64, h=32, spp=8)
    a = render_adaptive(scene, cam, cfg, tol=0.05, min_spp=2, chunk=2)
    b = render_adaptive(scene, cam, cfg, tol=0.05, min_spp=2, chunk=2)
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_adaptive_matches_uniform_statistically():
    """The adaptive estimate differs from the uniform render by no more
    than uniform MC self-noise (the optional-stopping bias stays inside
    the tolerance it was asked to hit)."""
    from spira_tpu.io import image as img_io
    from spira_tpu.render import render_flat

    scene, cam, cfg = _demo(w=96, h=64, spp=32)
    ad = render_adaptive(scene, cam, cfg, tol=0.05, min_spp=4, chunk=4)
    kw = dict(width=96, height=64, spp=32, max_depth=3)
    un0 = np.asarray(img_io.assemble_image(
        render_flat(scene, cam, seed=0, **kw), 96, 64))
    un1 = np.asarray(img_io.assemble_image(
        render_flat(scene, cam, seed=1, **kw), 96, 64))
    rmse_ad = np.sqrt(np.mean((ad - un0) ** 2))
    self_noise = np.sqrt(np.mean((un1 - un0) ** 2))
    assert rmse_ad <= 1.25 * self_noise, (rmse_ad, self_noise)


def test_row_set_raygen_matches_contiguous():
    """generate_rays(rows=arange(row_start, row_start+n)) is exactly the
    contiguous row-range raygen under the same key."""
    from spira_tpu.core import rng as srng
    from spira_tpu.scene.camera import generate_rays

    cam = st.default_camera(2.0)
    key = srng.sample_key(srng.base_key(7), 3)
    o1, d1 = generate_rays(cam, 32, 16, key, row_start=4, n_rows=8)
    o2, d2 = generate_rays(cam, 32, 16, key,
                           rows=jnp.arange(4, 12, dtype=jnp.int32))
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def test_run_config_adaptive_end_to_end(tmp_path):
    from spira_tpu.pipeline import run_config

    out = str(tmp_path / "ad.png")
    cfg = RenderConfig(width=48, height=32, spp=4, max_depth=2,
                       adaptive_tol=0.1, adaptive_min_spp=2,
                       output=out, progress=False)
    img = run_config(cfg)
    assert img.shape == (32, 48, 3)
    from PIL import Image

    assert Image.open(out).size == (48, 32)
    # composes with tile sharding (virtual devices in tests)
    img = run_config(RenderConfig(width=48, height=32, spp=4, max_depth=2,
                                  adaptive_tol=0.1, adaptive_min_spp=2,
                                  n_tile=2, output="", progress=False))
    assert img.shape == (32, 48, 3)


def test_adaptive_checkpoint_resume_is_exact(tmp_path):
    """Interrupt an adaptive render mid-flight and resume: bit-identical
    to the uninterrupted run (counter-based keys + the full convergence
    ledger in the checkpoint)."""
    from spira_tpu.utils import checkpoint as ckpt

    scene = st.create_scene()
    cam = st.default_camera(64 / 32)
    ckdir = str(tmp_path / "ck")
    cfg = RenderConfig(width=64, height=32, spp=12, max_depth=2,
                       checkpoint_dir=ckdir, progress=False)
    kw = dict(tol=0.08, min_spp=4, chunk=4)

    uninterrupted = render_adaptive(
        scene, cam,
        RenderConfig(width=64, height=32, spp=12, max_depth=2,
                     checkpoint_dir=None, progress=False),
        **kw)

    # "interrupt": run with a budget that stops after the first round by
    # monkeying the loop via a tiny spp cap is wrong (different retirement)
    # — instead run the checkpointed render fully, then REPLAY from its
    # mid-flight checkpoint and check the tail agrees.
    full = render_adaptive(scene, cam, cfg, **kw)
    np.testing.assert_array_equal(full, uninterrupted)
    state = ckpt.load_adaptive_state(ckdir)
    assert state is not None  # a mid-flight round was persisted
    resumed = render_adaptive(scene, cam, cfg, **kw)  # resumes + finishes
    np.testing.assert_array_equal(resumed, full)
    # hyperparameter mismatch -> fresh start, still correct
    fresh = render_adaptive(scene, cam, cfg, tol=0.08, min_spp=4, chunk=2)
    assert np.isfinite(fresh).all()


def test_adaptive_mesh_scene_with_packet_intersect():
    """Adaptive driver on a BVH mesh scene, every bounce's nearest-hit
    through the default intersect (the stackless BVH walk): finite,
    deterministic, and statistically consistent with the uniform wavefront
    render of the same scene."""
    from spira_tpu.accel.bvh import build_bvh
    from spira_tpu.core.types import replace
    from spira_tpu.render import render_flat
    from spira_tpu.scene.camera import make_camera
    from spira_tpu.scene.geometry import triangle_bounds
    from spira_tpu.scene.scene import create_mesh_scene

    # leaf<=4 rebuild: the walk's compile scales with the leaf unroll
    scene = create_mesh_scene(subdivisions=0)
    lo, hi = triangle_bounds(scene.triangles)
    scene = replace(
        scene, bvh=build_bvh(np.asarray(lo), np.asarray(hi), leaf_size=4)
    )
    cam = make_camera(lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      aspect_ratio=64.0 / 32.0)
    cfg = RenderConfig(width=64, height=32, spp=8, max_depth=2,
                       progress=False)
    a = render_adaptive(scene, cam, cfg, tol=0.1, min_spp=2, chunk=2)
    b = render_adaptive(scene, cam, cfg, tol=0.1, min_spp=2, chunk=2)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and a.std() > 1e-3
    from spira_tpu.io.image import assemble_image

    un = np.asarray(assemble_image(
        render_flat(scene, cam, width=64, height=32, spp=8, max_depth=2),
        64, 32))
    assert np.sqrt(np.mean((a - un) ** 2)) < 0.35  # MC noise at spp<=8


def test_adaptive_spectral_runs_and_is_deterministic():
    """Spectral transport under the adaptive driver (hero-wavelength
    wavefront per row set)."""
    scene = st.create_scene()
    cam = st.default_camera(2.0)
    cfg = RenderConfig(width=48, height=24, spp=4, max_depth=2,
                       spectral=True, progress=False)
    a = render_adaptive(scene, cam, cfg, tol=0.1, min_spp=2, chunk=2)
    b = render_adaptive(scene, cam, cfg, tol=0.1, min_spp=2, chunk=2)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and a.std() > 1e-3
