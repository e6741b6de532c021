"""Smoke run of spira_tpu on NVIDIA GPUs: every main path, once, at the
flagship sizes, each compared with the repository's own reference.

    python chip_smoke.py              # all phases on one GPU
    python chip_smoke.py --four-gpus  # only the four-GPU sharded paths

Each phase prints one JSON line: what it ran and at which shapes, compile
and steady times, the process's ``peak_bytes_in_use`` so far, the
``memory_analysis()`` of each compiled step, and each comparison with its
tolerance.  A failed phase raises, so the script exits non-zero; nothing
catches it.  The last line is ``{"ok": true, "device": {...}}``.

Without a GPU the script exits non-zero before printing any result.  It
reads nothing outside the repository (scenes are made in code from a
seed) and writes only under ``chiprun_out/chip_smoke/``.  Compiled programs
go to the persistent compile cache (`spira_tpu.utils.cache`).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

W, H, SPP, DEPTH = 640, 360, 16, 4  # the flagship render (BASELINE.md)
FLAGSHIP = dict(width=W, height=H, spp=SPP, max_depth=DEPTH)


class SmokeFailure(AssertionError):
    pass


def require_gpu(devices=None):
    """Refuse to run anywhere but on a GPU: no result is printed first."""
    import jax

    devices = jax.devices() if devices is None else devices
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform "
            f"{devices[0].platform!r}); this script measures the card only"
        )
    return devices


def _memory(compiled) -> dict:
    stats = compiled.memory_analysis()
    names = ("argument_size_in_bytes", "output_size_in_bytes",
             "alias_size_in_bytes", "temp_size_in_bytes",
             "generated_code_size_in_bytes")
    return {n: int(getattr(stats, n)) for n in names if hasattr(stats, n)}


def _nonfinite(tree) -> list:
    """Paths of the leaves of ``tree`` that hold a NaN or an infinity."""
    import jax
    import numpy as np

    return [jax.tree_util.keystr(path)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)
            if not np.isfinite(np.asarray(x)).all()]


def _finite(tree) -> bool:
    return not _nonfinite(tree)


class Phase:
    """One phase's record: compiles, timings, checks; printed by done()."""

    def __init__(self, name: str, ran: str, **shape):
        self.t0 = time.perf_counter()
        self.rec = {"phase": name, "ran": ran, **shape, "compile_s": {},
                    "steady_ms": {}, "memory_analysis": {}, "checks": []}

    def compile(self, label, fn, *args):
        """AOT-compile ``fn`` (jitted here unless already) for ``args``."""
        import jax

        jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
        t = time.perf_counter()
        compiled = jitted.lower(*args).compile()
        self.rec["compile_s"][label] = round(time.perf_counter() - t, 3)
        self.rec["memory_analysis"][label] = _memory(compiled)
        return compiled

    def steady(self, label, compiled, *args, iters=5):
        """Run once (warm), then time ``iters`` calls; returns the output."""
        import jax

        out = jax.block_until_ready(compiled(*args))
        t = time.perf_counter()
        for _ in range(iters):
            out = compiled(*args)
        jax.block_until_ready(out)
        self.rec["steady_ms"][label] = round(
            (time.perf_counter() - t) / iters * 1e3, 4
        )
        return out

    def check(self, what, ok, tolerance, **measured):
        self.rec["checks"].append(
            {"check": what, "tolerance": tolerance, "ok": bool(ok),
             **{k: (float(v) if hasattr(v, "__float__") else v)
                for k, v in measured.items()}}
        )
        if not ok:
            self.done()
            raise SmokeFailure(f"{self.rec['phase']}: {what} failed "
                               f"({measured}; tolerance {tolerance})")

    def done(self):
        import jax

        stats = jax.devices()[0].memory_stats() or {}  # None off the GPU
        self.rec["peak_bytes_in_use"] = int(
            stats.get("peak_bytes_in_use", -1)
        )
        self.rec["wall_s"] = round(time.perf_counter() - self.t0, 3)
        print(json.dumps(self.rec), flush=True)


def same_stream_close(got, want):
    """Two renders of one PCG stream compiled separately: a contracted
    multiply-add can flip a threshold (Russian roulette, a lobe choice)
    and send a few paths elsewhere, so most pixels agree to rounding and
    a handful may not.  Returns (ok, measured, tolerance)."""
    import numpy as np

    d = np.abs(np.asarray(got) - np.asarray(want)).max(axis=-1)
    measured = dict(mean_abs_diff=d.mean(), max_abs_diff=d.max(),
                    frac_within_1e3=(d <= 1e-3).mean())
    ok = (measured["mean_abs_diff"] <= 1e-4
          and measured["frac_within_1e3"] >= 0.995)
    return ok, measured, "mean|d| <= 1e-4 and >= 99.5% of pixels within 1e-3"


def statistically_close(got, other_a, other_b, mean_tol):
    """``got`` against an engine with another RNG family: its error to one
    render of that engine must stay within 1.3x the engine's own noise
    floor (the same render at a second seed), and the image means agree."""
    import numpy as np

    got, a, b = (np.asarray(x) for x in (got, other_a, other_b))
    floor = np.abs(a - b).mean()
    measured = dict(mean_abs_diff=np.abs(got - a).mean(), noise_floor=floor,
                    mean_got=got.mean(), mean_other=a.mean())
    ok = (measured["mean_abs_diff"] < 1.3 * floor
          and abs(got.mean() - a.mean()) < mean_tol)
    return ok, measured, (f"mean|d| < 1.3 x noise floor and |mean diff| < "
                          f"{mean_tol}")


# ----------------------------------------------------------------------------
# One-GPU phases
# ----------------------------------------------------------------------------


def phase_device(devices, card):
    import jax

    from spira_tpu.utils.cache import enable_compile_cache

    ph = Phase("device", "jax.devices()")
    ph.rec.update(platform=devices[0].platform,
                  device_kind=devices[0].device_kind, count=len(devices),
                  card=card, jax=jax.__version__,
                  compile_cache=enable_compile_cache())
    ph.check("platform is gpu", devices[0].platform == "gpu", "== 'gpu'")
    ph.done()


def phase_flagship_forward(kw=FLAGSHIP):
    import jax.numpy as jnp

    import spira_tpu as st
    from spira_tpu.kernels.megakernel import render_flat_fused
    from spira_tpu.render import (
        ENGINE_TABLE,
        render_flat_engine,
        select_engine,
    )

    w, h = kw["width"], kw["height"]
    scene = st.create_scene()
    cam = st.default_camera(w / h)
    engine = select_engine(scene, "physical", False)
    ph = Phase("flagship_forward", f"render_flat_engine(engine='auto') -> "
               f"{engine}, against render_flat_fused", **kw)
    ph.check("auto picks the table's GPU engine",
             engine == ENGINE_TABLE["gpu"]["small"], "== ENGINE_TABLE row")
    seed = jnp.int32(3)
    auto = ph.compile(
        engine, lambda sc, c, s: render_flat_engine(sc, c, seed=s, **kw),
        scene, cam, seed)
    fused = ph.compile(
        "fused", lambda sc, c, s: render_flat_fused(sc, c, seed=s, **kw),
        scene, cam, seed)
    got = ph.steady(engine, auto, scene, cam, seed, iters=20)
    want = ph.steady("fused", fused, scene, cam, seed, iters=20)
    ph.check("shape and finite", got.shape == (w * h, 3) and _finite(got),
             "(H*W, 3), all finite")
    ok, measured, tol = same_stream_close(got, want)
    ph.check(f"{engine} vs fused, same seed", ok, tol, **measured)
    ph.done()
    return scene, cam, want


def phase_flagship_step(scene, cam, target, kw=FLAGSHIP,
                        fd_kw=dict(width=96, height=54, spp=64,
                                   max_depth=DEPTH)):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import make_step
    from spira_tpu.core.types import replace
    from spira_tpu.kernels.megakernel import render_flat_fused

    spp = kw["spp"]
    ph = Phase("flagship_step", "bench.make_step: render_flat_hybrid_grad "
               "-> MSE -> value_and_grad(materials)", **kw)
    seed = jnp.int32(5)
    mats = scene.materials
    results = {}
    for grad_spp in (spp, 4):
        step = ph.compile(f"grad_spp={grad_spp}",
                          make_step(scene, cam, target, grad_spp=grad_spp,
                                    **kw), mats, seed)
        results[grad_spp] = ph.steady(f"grad_spp={grad_spp}", step, mats,
                                      seed, iters=10)
        bad = _nonfinite(results[grad_spp])
        ph.check(f"grad_spp={grad_spp}: loss and gradients finite",
                 not bad, "all finite", nonfinite=bad)

    @jax.jit
    def fused_step(m, s):
        def loss_fn(m):
            img = render_flat_fused(replace(scene, materials=m), cam, seed=s,
                                    **kw)
            return jnp.mean((img - target) ** 2)

        return jax.value_and_grad(loss_fn)(m)

    ref = ph.compile("fused value_and_grad", fused_step, mats, seed)
    ref_loss, ref_g = ph.steady("fused value_and_grad", ref, mats, seed,
                                iters=3)
    loss, g = results[spp]
    gl = jax.tree_util.tree_leaves(g)
    rl = jax.tree_util.tree_leaves(ref_g)
    scale = max(float(np.abs(np.asarray(x)).max()) for x in rl)
    worst = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(gl, rl))
    # the hybrid's forward is the kernel's image, which differs from the
    # fused one on a handful of pixels (see same_stream_close); its
    # backward replays the fused twin itself
    ph.check("exact replay vs value_and_grad through render_flat_fused",
             worst <= 1e-3 * scale and abs(float(loss) - float(ref_loss))
             <= 1e-4 * abs(float(ref_loss)),
             "max|dg| <= 1e-3 max|g|, |dloss| <= 1e-4 loss",
             max_grad_diff=worst, grad_scale=scale, loss=loss,
             ref_loss=ref_loss)

    # central differences on the two largest albedo components, at a
    # reduced size (max_depth 4 keeps Russian roulette off: smooth loss)
    fd_target = jnp.zeros((fd_kw["width"] * fd_kw["height"], 3),
                          jnp.float32) + 0.25
    fd_step = ph.compile("central differences",
                         make_step(scene, cam, fd_target,
                                   grad_spp=fd_kw["spp"], **fd_kw),
                         mats, seed)
    _, g_small = fd_step(mats, seed)
    ga = np.asarray(g_small.albedo)
    flat = np.argsort(-np.abs(ga).ravel())[:2]
    eps = 2e-3
    for k in flat:
        i, j = np.unravel_index(k, ga.shape)
        loss_at = []
        for sign in (1.0, -1.0):
            a = np.asarray(mats.albedo, np.float64).copy()
            a[i, j] += sign * eps
            m2 = replace(mats, albedo=jnp.asarray(a, jnp.float32))
            loss_at.append(float(fd_step(m2, seed)[0]))
        fd = (loss_at[0] - loss_at[1]) / (2 * eps)
        ph.check(f"central difference albedo[{i},{j}] at "
                 f"{fd_kw['width']}x{fd_kw['height']} spp{fd_kw['spp']}",
                 abs(fd - ga[i, j]) <= max(2e-3, 0.06 * abs(fd)),
                 "|fd - g| <= max(2e-3, 0.06|fd|)", fd=fd, grad=ga[i, j])
    ph.done()


def phase_reference_semantics():
    import numpy as np

    import spira_tpu as st
    from tests.reference_impl import (
        CPUReferenceRenderer,
        default_camera_dict,
        default_scene,
    )

    w, h, spp, depth = 24, 14, 96, 4  # tests/test_golden_reference.py
    ph = Phase("reference_semantics", "wavefront semantics='reference' vs "
               "the scalar oracle tests/reference_impl.py", width=w,
               height=h, spp=spp, max_depth=depth)
    scene = st.create_scene()
    t = time.perf_counter()
    img = np.asarray(st.render_hdr(scene, st.default_camera(w / h), w, h,
                                   spp=spp, max_depth=depth,
                                   semantics="reference", seed=77))
    ph.rec["compile_s"]["wavefront (with run)"] = round(
        time.perf_counter() - t, 3)
    spheres, materials = default_scene()
    oracle = CPUReferenceRenderer(spheres, materials,
                                  np.random.default_rng(1234)).render_hdr(
        default_camera_dict(w / h), w, h, spp=spp, max_depth=depth)
    diff = np.abs(img - oracle)
    ph.check("statistical match to the oracle",
             diff.mean() < 0.03 and (diff > 0.25).mean() < 0.02
             and abs(img.mean() - oracle.mean()) <= 0.02 * abs(oracle.mean()),
             "mean|d| < 0.03, < 2% of channels off by > 0.25, means within "
             "2%", mean_abs_diff=diff.mean(),
             frac_off=(diff > 0.25).mean(), mean=img.mean(),
             oracle_mean=oracle.mean())
    ph.done()


def _brute_winner(tris, origins, dirs, chunk=128):
    """Nearest triangle by testing every one: (t, index), INF on a miss."""
    import jax
    import jax.numpy as jnp

    from spira_tpu.core.vecmath import INF, T_MIN
    from spira_tpu.integrator.intersect import _moller_trumbore

    def one(args):
        o, d = args
        t, u, v, det = _moller_trumbore(tris, o, d)
        valid = ((jnp.abs(det) > 1e-9) & (u >= 0.0) & (v >= 0.0)
                 & (u + v <= 1.0) & (t > T_MIN))
        t = jnp.where(valid, t, INF)
        return jnp.min(t, axis=1), jnp.argmin(t, axis=1).astype(jnp.int32)

    n = origins.shape[0]
    t, idx = jax.lax.map(one, (origins.reshape(n // chunk, chunk, 3),
                               dirs.reshape(n // chunk, chunk, 3)))
    return t.reshape(n), idx.reshape(n)


def phase_mesh_forward(kw=FLAGSHIP, n_rays=4096):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import spira_tpu as st
    from spira_tpu.accel.traverse import bvh_winner
    from spira_tpu.core.vecmath import INF
    from spira_tpu.render import render_flat
    from spira_tpu.scene.bunny import bunny_camera, create_bunny_scene
    from spira_tpu.scene.camera import generate_rays

    w, h = kw["width"], kw["height"]
    t = time.perf_counter()
    scene, info = create_bunny_scene()
    build_s = time.perf_counter() - t
    cam = bunny_camera(w / h)
    ph = Phase("mesh_forward", "render(bunny) through the wavefront and "
               "accel/traverse.intersect_bvh", triangles=info["triangles"],
               nodes=info["nodes"], builder=info["builder"],
               bvh_build_s=round(build_s, 3), check_rays=n_rays, **kw)
    seed = jnp.int32(0)
    fwd = ph.compile("render_flat", lambda sc, c, s: render_flat(
        sc, c, seed=s, **kw), scene, cam, seed)
    flat = ph.steady("render_flat", fwd, scene, cam, seed, iters=3)
    ph.check("render finite", _finite(flat), "all finite")
    img = st.render(scene, cam, w, h, samples_per_pixel=kw["spp"],
                    max_depth=kw["max_depth"])
    ph.check("render() output", img.shape == (h, w, 3) and img.std() > 1,
             "(H, W, 3) uint8, not flat", std=img.std())

    tris = scene.triangles
    walk = jax.jit(lambda o, d: bvh_winner(scene.bvh, tris, o, d))
    brute = jax.jit(lambda o, d: _brute_winner(tris, o, d))
    origins, dirs = generate_rays(cam, w, h, jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    pick = rng.choice(w * h, n_rays, replace=False)
    primary = (origins[pick], dirs[pick])

    # first-bounce rays: from mesh hits of the primary wavefront, leave
    # along the face-forwarded normal plus a random unit vector
    t_all, p_all = walk(origins, dirs)
    hits = np.flatnonzero(np.asarray(t_all) < INF)
    sel = rng.choice(hits, n_rays, replace=len(hits) < n_rays)
    o, d = origins[sel], dirs[sel]
    n = tris.normal[p_all[sel]]
    n = jnp.where(jnp.sum(n * d, axis=1, keepdims=True) > 0, -n, n)
    r = jnp.asarray(rng.normal(size=(n_rays, 3)), jnp.float32)
    nd = n + r / jnp.linalg.norm(r, axis=1, keepdims=True)
    nd = nd / jnp.linalg.norm(nd, axis=1, keepdims=True)
    bounce = (o + t_all[sel][:, None] * d + 1e-4 * n, nd)

    for name, (ro, rd) in (("primary", primary), ("first_bounce", bounce)):
        tw, pw = (np.asarray(x) for x in walk(ro, rd))
        tb, pb = (np.asarray(x) for x in brute(ro, rd))
        hit = tb < INF
        same_hit = (tw < INF) == hit
        # a differing winner is allowed only where two triangles tie at
        # exactly the same t (a ray through a shared edge)
        differ = hit & (pw != pb) & (tw != tb)
        rel = np.abs(tw[hit] - tb[hit]) / np.maximum(np.abs(tb[hit]), 1e-6)
        ph.check(f"{name}: walk vs brute force over every triangle",
                 same_hit.all() and not differ.any()
                 and (rel.max(initial=0.0) <= 1e-5),
                 "same hit set, same winner (ties at equal t excepted), t "
                 "within 1e-5 relative", rays=len(tb), hit_rays=hit.sum(),
                 winner_ties=(hit & (pw != pb)).sum(),
                 max_rel_t=rel.max(initial=0.0))
    ph.done()


def phase_mesh_gradient(kw=FLAGSHIP):
    import jax
    import jax.numpy as jnp

    import spira_tpu as st
    from spira_tpu.core.types import replace
    from spira_tpu.render import render_flat_hybrid_grad_mesh
    from spira_tpu.scene.camera import make_camera

    scene = st.create_mesh_scene()
    cam = make_camera(lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      aspect_ratio=kw["width"] / kw["height"])
    ph = Phase("mesh_gradient", "render_flat_hybrid_grad_mesh -> MSE -> "
               "grad(albedo)", triangles=int(scene.triangles.count),
               grad_spp=2, **kw)
    target = jnp.zeros((kw["width"] * kw["height"], 3), jnp.float32) + 0.25
    seed = jnp.int32(1)

    def loss_fn(albedo, s):
        sc = replace(scene, materials=replace(scene.materials, albedo=albedo))
        img = render_flat_hybrid_grad_mesh(sc, cam, seed=s, grad_spp=2,
                                           **kw)
        return jnp.mean((img - target) ** 2)

    a0 = scene.materials.albedo
    fwd = ph.compile("forward", loss_fn, a0, seed)
    step = ph.compile("forward+backward", jax.value_and_grad(loss_fn), a0,
                      seed)
    ph.steady("forward", fwd, a0, seed, iters=2)
    loss, g = ph.steady("forward+backward", step, a0, seed, iters=2)
    ph.check("loss and gradients finite, gradient nonzero",
             _finite((loss, g)) and float(jnp.abs(g).max()) > 0,
             "all finite, max|g| > 0", loss=loss, max_grad=jnp.abs(g).max())
    ph.done()


def phase_spectral(kw=dict(width=512, height=512, spp=128, max_depth=6),
                   wavefront_spp=32):
    import jax.numpy as jnp

    import spira_tpu as st
    from spira_tpu.render import render_flat, render_flat_engine, select_engine

    scene = st.create_cornell_box()
    cam = st.cornell_camera(1.0)
    wkw = dict(kw, spp=wavefront_spp)
    engine = select_engine(scene, "physical", True)
    ph = Phase("spectral", f"render(spectral=True) -> {engine}, against the "
               "spectral wavefront at two seeds",
               wavefront_spp=wavefront_spp,
               note=f"wavefront spp cut {kw['spp']} -> {wavefront_spp} to "
                    "fit the call", **kw)
    seed = jnp.int32(0)
    auto = ph.compile(engine, lambda sc, c, s: render_flat_engine(
        sc, c, seed=s, spectral=True, **kw), scene, cam, seed)
    img = ph.steady(engine, auto, scene, cam, seed, iters=3)
    wave = ph.compile("wavefront", lambda sc, c, s: render_flat(
        sc, c, seed=s, spectral=True, **wkw), scene, cam, seed)
    wf1 = ph.steady("wavefront", wave, scene, cam, jnp.int32(1), iters=1)
    wf2 = wave(scene, cam, jnp.int32(2))
    ph.check("finite", _finite(img), "all finite")
    w, h = kw["width"], kw["height"]
    out = st.render(scene, cam, w, h, samples_per_pixel=kw["spp"],
                    max_depth=kw["max_depth"], spectral=True)
    ph.check("render() output", out.shape == (h, w, 3), "(H, W, 3) uint8")
    # Chebyshev-compressed SPDs against the exact tables: a few percent
    # on saturated colours (kernels/spectral_fused.py), hence the mean
    # tolerance of tests/test_spectral.py
    ok, measured, tol = statistically_close(img, wf1, wf2, mean_tol=0.07)
    ph.check(f"{engine} vs spectral wavefront", ok, tol, **measured)
    ph.done()


def phase_entry_points(render_args=(), inverse_size=("160", "90", "4"),
                       resume_size=(320, 180)):
    import numpy as np

    from spira_tpu import cli
    from spira_tpu.io.image import load_exr
    from spira_tpu.pipeline import _render_chunk, run_config
    from spira_tpu.utils import checkpoint as ckpt
    from spira_tpu.utils.config import RenderConfig, build_scene

    os.makedirs(OUT_DIR, exist_ok=True)
    ph = Phase("entry_points", "cli render, cli inverse, "
               "pipeline.run_config with checkpoint resume")
    png = os.path.join(OUT_DIR, "cli_render.png")
    t = time.perf_counter()
    rc = cli.main(["render", "-o", png, "--no-progress", *render_args])
    ph.rec["compile_s"]["cli render (with run)"] = round(
        time.perf_counter() - t, 3)
    ph.check("cli render writes a PNG", rc == 0 and os.path.getsize(png) > 0,
             "rc 0, non-empty file")

    t = time.perf_counter()
    iw, ih, ispp = inverse_size
    rc = cli.main(["inverse", "--steps", "5", "--width", iw, "--height",
                   ih, "--spp", ispp, "-o",
                   os.path.join(OUT_DIR, "cli_inverse.png"), "--no-progress"])
    ph.rec["compile_s"]["cli inverse (with run)"] = round(
        time.perf_counter() - t, 3)
    ph.check("cli inverse: 5 steps, finite loss", rc == 0,
             "rc 0 (non-zero on a non-finite loss)")

    ckdir = os.path.join(OUT_DIR, "checkpoint")
    shutil.rmtree(ckdir, ignore_errors=True)
    common = dict(scene="default", width=resume_size[0],
                  height=resume_size[1], spp=8, max_depth=4, progress=False)
    cfg = RenderConfig(**common, checkpoint_dir=ckdir, checkpoint_every=4,
                       output=os.path.join(OUT_DIR, "resumed.exr"))
    scene, cam = build_scene(cfg)
    # the first chunk, saved as a checkpoint: the run stopped after it
    first = _render_chunk(scene, cam, np.int32(0), width=cfg.width,
                          height=cfg.height, n_samples=4,
                          max_depth=cfg.max_depth, semantics=cfg.semantics,
                          spectral=False, seed=cfg.seed)
    ckpt.save_render_state(ckdir, accumulator=first, samples_done=4,
                           seed=cfg.seed, config_json=cfg.to_json())
    t = time.perf_counter()
    run_config(cfg)  # resumes at sample 4
    one = RenderConfig(**common, checkpoint_dir=os.path.join(ckdir, "one"),
                       output=os.path.join(OUT_DIR, "one_shot.exr"))
    run_config(one)
    ph.rec["compile_s"]["run_config x2 (with runs)"] = round(
        time.perf_counter() - t, 3)
    resumed = np.asarray(load_exr(cfg.output))
    one_shot = np.asarray(load_exr(one.output))
    d = np.abs(resumed - one_shot)
    ph.check("resumed image equals the one-shot image",
             np.allclose(resumed, one_shot, rtol=1e-5, atol=1e-6),
             "allclose rtol 1e-5 atol 1e-6 (chunk sums add in another "
             "order)", max_abs_diff=d.max())
    ph.done()


# ----------------------------------------------------------------------------
# Four-GPU phases (--four-gpus)
# ----------------------------------------------------------------------------


def phase_sharded_forward(width=1920, height=1080, spp=16, depth=DEPTH):
    import jax.numpy as jnp

    import spira_tpu as st
    from spira_tpu.kernels.megakernel import render_flat_fused
    from spira_tpu.parallel.mesh import make_mesh, replicate
    from spira_tpu.parallel.sharded import render_flat_sharded

    mesh = make_mesh(n_tile=2, n_spp=2)
    scene = st.create_scene()
    cam = st.default_camera(width / height)
    ph = Phase("sharded_forward", "parallel.sharded.render_flat_sharded("
               "engine='fused') on tile 2 x spp 2, against the one-GPU "
               "render_flat_fused", width=width, height=height, spp=spp,
               max_depth=depth, mesh="tile=2 spp=2",
               note="config 5 (1920x1080) with spp cut 256 -> 16")
    kw = dict(width=width, height=height, spp=spp, max_depth=depth)
    rs, rc = replicate(scene, mesh), replicate(cam, mesh)
    sharded = ph.compile("sharded", lambda sc, c: render_flat_sharded(
        sc, c, mesh=mesh, seed=11, engine="fused", **kw), rs, rc)
    single = ph.compile("one gpu", lambda sc, c, s: render_flat_fused(
        sc, c, seed=s, **kw), scene, cam, jnp.int32(11))
    got = ph.steady("sharded", sharded, rs, rc, iters=3)
    want = ph.steady("one gpu", single, scene, cam, jnp.int32(11), iters=3)
    ph.check("finite", _finite(got), "all finite")
    # pixel ids and sample indices are global, so the image is sharding-
    # invariant up to the psum's order and the programs' own rounding
    ok, measured, tol = same_stream_close(got, want)
    ph.check("sharded vs one GPU, same seed", ok, tol, **measured)
    ph.done()


def phase_sharded_inverse(width=256, height=128, spp=8, depth=DEPTH):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import spira_tpu as st
    from spira_tpu.core import rng as srng
    from spira_tpu.core.types import replace
    from spira_tpu.diff.inverse import (
        make_inverse_step,
        mse_loss,
        render_for_grad,
    )
    from spira_tpu.parallel.mesh import make_mesh, replicate
    from spira_tpu.render import accumulate_rows

    n_tile, n_spp = 2, 2
    rows, spp_per = height // n_tile, spp // n_spp
    mesh = make_mesh(n_tile=n_tile, n_spp=n_spp)
    scene = st.create_scene()
    cam = st.default_camera(width / height)
    kw = dict(width=width, height=height, spp=spp, max_depth=depth)
    ph = Phase("sharded_inverse", "diff.inverse.make_inverse_step(mesh=...) "
               "on tile 2 x spp 2, against the same shards computed in turn "
               "on one GPU and summed", mesh="tile=2 spp=2", **kw)
    rs, rc = replicate(scene, mesh), replicate(cam, mesh)
    target = jnp.zeros((width * height, 3), jnp.float32) + 0.25
    params = {"albedo": scene.materials.albedo * 0.5,
              "emission": scene.materials.emission * 2.0}
    step_idx = 3

    def sharded_loss(p):
        return mse_loss(render_for_grad(p, rs, rc, seed=step_idx, mesh=mesh,
                                        **kw), target)

    def one_shard(p, t, s, cotangent):
        """One (tile, spp) shard's radiance sum and its VJP, as the shard
        body computes it (tile rows and sample offset from t and s)."""
        def acc(p):
            sc = replace(scene, materials=replace(scene.materials, **p))
            base = jax.random.fold_in(srng.base_key(0), step_idx)
            return accumulate_rows(
                sc, cam, base, width=width, height=height,
                row_start=t * rows, n_rows=rows, sample_offset=s * spp_per,
                n_samples=spp_per, max_depth=depth, semantics="physical",
            )

        out, vjp = jax.vjp(acc, p)
        return out, vjp(cotangent)[0]

    step, init = make_inverse_step(mesh=mesh, **kw)
    opt = init(params)
    train = ph.compile("make_inverse_step", step, params, opt, rs, rc,
                       target, step_idx)
    _, _, step_loss = ph.steady("make_inverse_step", train, params, opt, rs,
                                rc, target, step_idx, iters=2)
    g_shard = ph.compile("sharded value_and_grad",
                         jax.value_and_grad(sharded_loss), params)
    loss_s, grads_s = ph.steady("sharded value_and_grad", g_shard, params,
                                iters=2)

    # in turn on one GPU: every shard's forward, the loss's cotangent on
    # the assembled image, then every shard's VJP, summed
    zero = jnp.zeros((rows * width, 3), jnp.float32)
    shard = ph.compile("one shard (fwd+vjp)", one_shard, params,
                       jnp.int32(0), jnp.int32(0), zero)
    t0 = time.perf_counter()
    shards = [(t, s) for t in range(n_tile) for s in range(n_spp)]
    accs = {ts: shard(params, jnp.int32(ts[0]), jnp.int32(ts[1]), zero)[0]
            for ts in shards}
    img = jnp.concatenate(
        [sum(accs[(t, s)] for s in range(n_spp)) for t in range(n_tile)]
    ) / jnp.float32(spp)
    loss_t, d_img = jax.value_and_grad(mse_loss)(img, target)
    grads_t = None
    for t, s in shards:
        ct = d_img[t * rows * width:(t + 1) * rows * width] / jnp.float32(spp)
        g = shard(params, jnp.int32(t), jnp.int32(s), ct)[1]
        grads_t = g if grads_t is None else jax.tree.map(jnp.add, grads_t, g)
    jax.block_until_ready(grads_t)
    ph.rec["steady_ms"]["in turn (4 shards x 2 passes)"] = round(
        (time.perf_counter() - t0) * 1e3, 4)

    ph.check("finite", _finite((step_loss, loss_s, grads_s)), "all finite")
    worst = max(float(np.abs(np.asarray(grads_s[k]) - np.asarray(grads_t[k]))
                      .max()) for k in params)
    scale = max(float(np.abs(np.asarray(grads_t[k])).max()) for k in params)
    ph.check("sharded step vs shards in turn",
             max(abs(float(step_loss) - float(loss_t)),
                 abs(float(loss_s) - float(loss_t)))
             <= 1e-5 * abs(float(loss_t))
             and worst <= 1e-4 * scale,
             "loss within 1e-5 relative, max|dg| <= 1e-4 max|g| (psum "
             "order)", step_loss=step_loss, loss_sharded=loss_s,
             loss_in_turn=loss_t, max_grad_diff=worst, grad_scale=scale)
    ph.done()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the sharded render and inverse step on "
                        "four GPUs, each against its one-GPU computation")
    args = p.parse_args(argv)

    import jax

    devices = require_gpu()
    if args.four_gpus and len(devices) != 4:
        raise SystemExit(f"chip_smoke --four-gpus needs 4 GPUs, found "
                         f"{len(devices)}")

    from bench import card
    from spira_tpu.utils.cache import enable_compile_cache

    card_name = card()
    print(f"card: {card_name} | jax {jax.__version__} | compile cache: "
          f"{enable_compile_cache()}", flush=True)
    t0 = time.perf_counter()
    phase_device(devices, card_name)
    if args.four_gpus:
        phase_sharded_forward()
        phase_sharded_inverse()
    else:
        scene, cam, target = phase_flagship_forward()
        phase_flagship_step(scene, cam, target)
        phase_reference_semantics()
        phase_mesh_forward()
        phase_mesh_gradient()
        phase_spectral()
        phase_entry_points()
    print(json.dumps({"total_wall_s": round(time.perf_counter() - t0, 3)}),
          flush=True)
    print(card_name, flush=True)
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
