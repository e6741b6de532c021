"""BASELINE config-5 scale proof: 1920x1080 spp=256, chunked + checkpointed.

Two modes, printed as one JSON line (and merged into ``--out`` if given):

* ``--mode gpu``     — the full config-5 frame on one GPU via the
  progressive driver (spp-chunked, sample-granular checkpoints), recording
  wall time, rays/s and peak device memory.  With ``--checkpoint`` it also
  kills a checkpointed run mid-render and resumes it.
* ``--mode virtual`` — the same program tile-sharded over an 8-device
  virtual CPU mesh (``xla_force_host_platform_device_count``), plus the
  1/2/4/8-device scaling sweep.  Virtual devices share physical cores, so
  these numbers validate the sharded program shape and reduction overhead,
  not multi-card scaling.

Usage: python benchmarks/config5.py --mode gpu [--spp 256] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def gpu_run(args):
    import jax

    from spira_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"--mode gpu needs a GPU; JAX found "
                 f"{jax.devices()[0].platform!r}")

    import spira_tpu as st
    from spira_tpu.pipeline import render_progressive
    from spira_tpu.utils.config import RenderConfig

    scene = st.create_scene()
    camera = st.default_camera(args.width / args.height)
    cfg = RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        max_depth=args.max_depth, seed=3,
        checkpoint_every=args.chunk, checkpoint_dir=args.ckpt_dir,
        progress=False,
    )
    t0 = time.perf_counter()
    img = render_progressive(scene, camera, cfg)
    dt = time.perf_counter() - t0
    rays = args.width * args.height * args.spp * args.max_depth
    stats = jax.local_devices()[0].memory_stats()
    import hashlib

    import numpy as np

    digest = hashlib.sha256(np.asarray(img, np.float32).tobytes()).hexdigest()
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "seconds": round(dt, 2),
        "rays_per_sec": round(rays / dt, 1),
        "chunks": -(-args.spp // args.chunk),
        "checkpointed": bool(args.ckpt_dir),
        "peak_bytes_in_use": stats["peak_bytes_in_use"],
        "image_mean": float(img.mean()),
        "image_sha256": digest,
    }


def checkpoint_run(args):
    """Crash-resume proof at flagship scale: run the checkpointed config-5
    frame to completion, then run it again in a subprocess KILLED
    mid-render, resume it, and require the resumed image to hash
    identically to the uninterrupted one (counter RNG + fixed chunk
    boundaries make the accumulation bit-exact).

    This parent never imports JAX: it starts its render children one at a
    time, so exactly one process holds the card at any moment."""
    import shutil
    import subprocess

    base = [sys.executable, os.path.abspath(__file__), "--mode", "gpu",
            "--width", str(args.width), "--height", str(args.height),
            "--spp", str(args.spp), "--max-depth", str(args.max_depth),
            "--chunk", str(args.chunk)]
    root = os.path.join(ROOT, "chiprun_out", "config5_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    d1, d2 = os.path.join(root, "a"), os.path.join(root, "b")

    def run_to_completion(ckpt_dir, timeout=3600):
        t0 = time.perf_counter()
        out = subprocess.run(base + ["--ckpt-dir", ckpt_dir],
                             capture_output=True, text=True, timeout=timeout)
        wall = time.perf_counter() - t0
        line = [l for l in out.stdout.splitlines() if l.startswith("{")][-1]
        return json.loads(line)["config5_gpu_single_chip"], wall, out

    # UNCHECKPOINTED control in the same session: separates checkpoint
    # overhead from drift and prices the save path explicitly.
    t0 = time.perf_counter()
    out0 = subprocess.run(base, capture_output=True, text=True, timeout=3600)
    line0 = [l for l in out0.stdout.splitlines() if l.startswith("{")][-1]
    res0 = json.loads(line0)["config5_gpu_single_chip"]

    res1, wall1, _ = run_to_completion(d1)
    # Kill the second run MID-RENDER, deterministically: watch its
    # checkpoint manifest and SIGKILL on the 3rd chunk save (of 8) —
    # timing-based kills race the compile cache (a cached second run can
    # finish before any wall-clock deadline scaled from the first).
    manifest = os.path.join(d2, "manifest.json")
    proc = subprocess.Popen(base + ["--ckpt-dir", d2],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    killed = False
    seen = set()
    deadline = time.time() + 3600
    while proc.poll() is None and time.time() < deadline:
        try:
            seen.add(os.stat(manifest).st_mtime_ns)
        except FileNotFoundError:
            pass
        if len(seen) >= 3:
            proc.kill()
            killed = True
            break
        time.sleep(0.2)
    proc.wait()
    res3, _, out3 = run_to_completion(d2)
    resumed = "resumed at sample" in (out3.stderr + out3.stdout)
    shutil.rmtree(root, ignore_errors=True)
    overhead = (res1["seconds"] - res0["seconds"]) / res0["seconds"]
    return {
        **res1,
        "uncheckpointed_seconds": res0["seconds"],
        "uncheckpointed_rays_per_sec": res0["rays_per_sec"],
        "uncheckpointed_image_sha256": res0["image_sha256"],
        "checkpoint_overhead_pct": round(100.0 * overhead, 1),
        "checkpoint_matches_uncheckpointed": (
            res0["image_sha256"] == res1["image_sha256"]
        ),
        "resume_killed_mid_render": killed,
        "resume_log_seen": resumed,
        "resume_exact": res3["image_sha256"] == res1["image_sha256"],
        "resumed_image_sha256": res3["image_sha256"],
    }


def virtual_run(args):
    import jax

    jax.config.update("jax_platforms", "cpu")

    import spira_tpu as st
    from spira_tpu.parallel.mesh import make_mesh, replicate
    from spira_tpu.parallel.sharded import render_flat_sharded
    from spira_tpu.pipeline import render_progressive
    from spira_tpu.utils.config import RenderConfig

    n_dev = jax.device_count()
    scene = st.create_scene()
    camera = st.default_camera(args.width / args.height)

    # config-5 shape, spp scaled down for CPU throughput; the program
    # (tile-sharded chunks + psum + checkpoint cadence) is the real one
    spp = args.virtual_spp
    cfg = RenderConfig(
        width=args.width, height=args.height, spp=spp,
        max_depth=args.max_depth, seed=3, checkpoint_every=args.chunk,
        progress=False,
    )
    mesh = make_mesh(n_tile=n_dev, n_spp=1)
    t0 = time.perf_counter()
    render_progressive(
        replicate(scene, mesh), replicate(camera, mesh), cfg, mesh=mesh
    )
    dt = time.perf_counter() - t0
    rays = args.width * args.height * spp * args.max_depth
    out = {
        "devices": n_dev,
        "spp": spp,
        "seconds": round(dt, 2),
        "rays_per_sec": round(rays / dt, 1),
        "note": "virtual CPU devices share physical cores: validates the "
                "sharded chunked program, not multi-card scaling",
    }

    sweep = []
    for n in (1, 2, 4, 8):
        if n > n_dev or args.height % n:
            continue
        m = make_mesh(n_tile=n, n_spp=1, devices=jax.devices()[:n])
        sc, cam = replicate(scene, m), replicate(camera, m)

        def run(seed):
            return render_flat_sharded(
                sc, cam, width=640, height=360, mesh=m, spp=16,
                max_depth=4, seed=seed, engine="fused",
            )

        jax.block_until_ready(run(0))
        t0 = time.perf_counter()
        for i in range(5):
            o = run(i + 1)
        jax.block_until_ready(o)
        dt = (time.perf_counter() - t0) / 5
        sweep.append(
            {"devices": n, "rays_per_sec": round(640 * 360 * 16 * 4 / dt, 1)}
        )
    return {"config5_virtual_mesh": out, "scaling_sweep_virtual": sweep}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["gpu", "virtual"], required=True)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--spp", type=int, default=256)
    p.add_argument("--virtual-spp", type=int, default=8)
    p.add_argument("--max-depth", type=int, default=4)
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--checkpoint", action="store_true",
                   help="checkpointed run + crash-resume bit-exactness proof")
    p.add_argument("--out", default="")
    args = p.parse_args()

    if args.mode == "gpu" and args.checkpoint:
        # the subprocess result already carries width/height/spp/max_depth
        res = {"config5_gpu_single_chip": checkpoint_run(args)}
    elif args.mode == "gpu":
        res = {"config5_gpu_single_chip": dict(
            width=args.width, height=args.height, spp=args.spp,
            max_depth=args.max_depth, **gpu_run(args))}
    else:
        res = virtual_run(args)

    print(json.dumps(res), flush=True)
    if args.out:
        merged = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                merged = json.load(f)
        merged.update(res)
        with open(args.out, "w") as f:
            json.dump(merged, f, indent=1)
        print(f"merged into {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
