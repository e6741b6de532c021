"""Config/CLI/pipeline/checkpoint tests (the aux subsystems of SURVEY.md §5)."""

import json

import numpy as np
import pytest

import spira_tpu as st
from spira_tpu.pipeline import render_progressive, run_config
from spira_tpu.utils import checkpoint as ckpt
from spira_tpu.utils.config import RenderConfig, build_scene


def tiny_cfg(**kw):
    base = dict(
        width=24, height=16, spp=4, max_depth=2, progress=False, output=""
    )
    base.update(kw)
    return RenderConfig(**base)


def test_config_json_round_trip():
    cfg = tiny_cfg(scene="cornell", spectral=True, lookfrom=(1, 2, 3))
    back = RenderConfig.from_json(cfg.to_json())
    assert back == cfg


def test_build_scene_variants():
    for name in ["default", "cornell", "mesh"]:
        cfg = tiny_cfg(scene=name)
        scene, cam = build_scene(cfg)
        assert scene.materials is not None
    with pytest.raises(ValueError):
        build_scene(tiny_cfg(scene="nope"))


def test_progressive_equals_single_shot():
    """Chunked accumulation with resume must be bit-identical to one shot
    (counter-based RNG: sample k is sample k)."""
    cfg = tiny_cfg(spp=6, checkpoint_every=2)
    scene, cam = build_scene(cfg)
    chunked = render_progressive(scene, cam, cfg)
    single = np.asarray(
        st.render_hdr(
            scene, cam, cfg.width, cfg.height, spp=6, max_depth=2, seed=0,
            engine="wavefront",  # the progressive pipeline's engine
        )
    )
    np.testing.assert_allclose(chunked, single, rtol=1e-5, atol=1e-6)


def test_checkpoint_resume_exact(tmp_path):
    ckdir = str(tmp_path / "ck")
    cfg = tiny_cfg(spp=6, checkpoint_every=2, checkpoint_dir=ckdir)
    scene, cam = build_scene(cfg)

    # Interrupt after the first chunk by running a truncated config, then
    # resume with the full one.
    cfg_half = tiny_cfg(spp=6, checkpoint_every=2, checkpoint_dir=ckdir)
    # run progressive but stop early: simulate by rendering spp=2 with the
    # SAME config json (so resume accepts it) — easiest: call internals.
    from jax import numpy as jnp

    from spira_tpu.pipeline import _render_chunk

    acc = _render_chunk(
        scene, cam, jnp.int32(0), width=cfg.width, height=cfg.height,
        n_samples=2, max_depth=cfg.max_depth, semantics=cfg.semantics,
        spectral=False, seed=cfg.seed,
    )
    ckpt.save_render_state(
        ckdir, accumulator=acc, samples_done=2, seed=cfg.seed,
        config_json=cfg.to_json(),
    )

    resumed = render_progressive(scene, cam, cfg)
    fresh = render_progressive(scene, cam, tiny_cfg(spp=6))
    np.testing.assert_allclose(resumed, fresh, rtol=1e-5, atol=1e-6)


def test_checkpoint_config_mismatch_restarts(tmp_path, caplog):
    ckdir = str(tmp_path / "ck2")
    cfg_a = tiny_cfg(spp=4, checkpoint_dir=ckdir, checkpoint_every=2)
    scene, cam = build_scene(cfg_a)
    ckpt.save_render_state(
        ckdir,
        accumulator=np.zeros((cfg_a.width * cfg_a.height, 3), np.float32),
        samples_done=2,
        seed=99,  # wrong seed → must not resume
        config_json=cfg_a.to_json(),
    )
    out = render_progressive(scene, cam, cfg_a)
    fresh = render_progressive(scene, cam, tiny_cfg(spp=4))
    np.testing.assert_allclose(out, fresh, rtol=1e-5, atol=1e-6)


def test_train_state_round_trip(tmp_path):
    import jax.numpy as jnp
    import optax

    params = {"albedo": jnp.ones((3, 3)), "emission": jnp.zeros((3, 3))}
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    d = str(tmp_path / "train")
    ckpt.save_train_state(d, params=params, opt_state=opt_state, step=7)
    restored = ckpt.load_train_state(d, params, opt_state)
    assert restored is not None
    p2, o2, step = restored
    assert step == 7
    np.testing.assert_array_equal(np.asarray(p2["albedo"]), np.ones((3, 3)))


def test_run_config_writes_output(tmp_path):
    out = str(tmp_path / "out.png")
    cfg = tiny_cfg(output=out)
    img = run_config(cfg)
    assert img.shape == (16, 24, 3)
    from PIL import Image

    assert Image.open(out).size == (24, 16)


def test_run_config_sharded(tmp_path):
    cfg = tiny_cfg(n_tile=4, n_spp_axis=2, spp=4, output="")
    img = run_config(cfg)
    assert img.shape == (16, 24, 3)


def test_sharded_progressive_equals_one_shot():
    """Sharded spp-chunked accumulation (the BASELINE config-5 driver shape)
    must reproduce the one-program sharded render exactly — chunks are keyed
    on absolute sample indices regardless of mesh shape."""
    from spira_tpu.parallel.mesh import make_mesh, replicate
    from spira_tpu.parallel.sharded import render_flat_sharded
    from spira_tpu.io import image as img_io

    cfg = tiny_cfg(spp=8, checkpoint_every=2, n_tile=4, n_spp_axis=2)
    scene, cam = build_scene(cfg)
    mesh = make_mesh(n_tile=4, n_spp=2)
    scene = replicate(scene, mesh)
    cam = replicate(cam, mesh)
    chunked = render_progressive(scene, cam, cfg, mesh=mesh)
    flat = render_flat_sharded(
        scene, cam, width=cfg.width, height=cfg.height, mesh=mesh, spp=8,
        max_depth=cfg.max_depth, seed=cfg.seed,
    )
    single = np.asarray(img_io.assemble_image(flat, cfg.width, cfg.height))
    np.testing.assert_allclose(chunked, single, rtol=1e-5, atol=1e-6)


def test_sharded_resume_mid_render(tmp_path):
    """Kill-and-resume mid-render on the sharded chunked driver: a
    checkpoint written after chunk 1 resumes to the same image a fresh
    sharded progressive run produces."""
    from spira_tpu.parallel.mesh import make_mesh, replicate
    from spira_tpu.parallel.sharded import render_chunk_sharded

    ckdir = str(tmp_path / "ck_sharded")
    cfg = tiny_cfg(
        spp=8, checkpoint_every=2, checkpoint_dir=ckdir, n_tile=4,
        n_spp_axis=2,
    )
    scene, cam = build_scene(cfg)
    mesh = make_mesh(n_tile=4, n_spp=2)
    scene = replicate(scene, mesh)
    cam = replicate(cam, mesh)

    acc = render_chunk_sharded(
        scene, cam, 0, width=cfg.width, height=cfg.height, mesh=mesh,
        n_samples=2, max_depth=cfg.max_depth, seed=cfg.seed,
    )
    ckpt.save_render_state(
        ckdir, accumulator=np.asarray(acc), samples_done=2, seed=cfg.seed,
        config_json=cfg.to_json(),
    )

    resumed = render_progressive(scene, cam, cfg, mesh=mesh)
    fresh_cfg = tiny_cfg(spp=8, checkpoint_every=2, n_tile=4, n_spp_axis=2)
    fresh = render_progressive(scene, cam, fresh_cfg, mesh=mesh)
    np.testing.assert_allclose(resumed, fresh, rtol=1e-5, atol=1e-6)


def test_cli_render_and_info(tmp_path, capsys):
    from spira_tpu.cli import main

    out = str(tmp_path / "cli.png")
    rc = main(
        [
            "render", "--width", "24", "--height", "16", "--spp", "2",
            "--max-depth", "2", "-o", out, "--no-progress",
        ]
    )
    assert rc == 0
    from PIL import Image

    assert Image.open(out).size == (24, 16)

    assert main(["info"]) == 0
    captured = capsys.readouterr()
    assert "backend" in captured.out


@pytest.mark.slow
def test_cli_inverse_smoke(tmp_path):
    from spira_tpu.cli import main

    rc = main(
        [
            "inverse", "--width", "16", "--height", "9", "--spp", "2",
            "--max-depth", "2", "--steps", "3", "-o",
            str(tmp_path / "inv.png"), "--no-progress",
        ]
    )
    assert rc == 0


def test_cli_presets_map_to_reference_tiers():
    import argparse

    from spira_tpu.utils.config import PRESETS, add_render_args, config_from_args

    p = argparse.ArgumentParser()
    add_render_args(p)
    cfg = config_from_args(p.parse_args(["--preset", "quality"]))
    assert (cfg.width, cfg.height, cfg.spp, cfg.max_depth) == (1280, 720, 100, 10)
    cfg = config_from_args(p.parse_args(["--preset", "quick"]))
    assert (cfg.width, cfg.height, cfg.spp) == (320, 180, 4)
    assert set(PRESETS) == {"quick", "demo", "quality"}
    # a typed flag beats the preset in ANY spelling: --width=, abbreviation,
    # programmatic argv (regression: sys.argv membership tests missed these)
    cfg = config_from_args(p.parse_args(["--preset", "demo", "--width=800"]))
    assert (cfg.width, cfg.height) == (800, 360)
    cfg = config_from_args(p.parse_args(["--preset", "quick", "--wid", "99"]))
    assert (cfg.width, cfg.height) == (99, 180)
    # no preset, no flags -> demo defaults
    cfg = config_from_args(p.parse_args([]))
    assert (cfg.width, cfg.height, cfg.spp, cfg.max_depth) == (640, 360, 32, 4)
