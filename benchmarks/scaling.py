"""Scaling-efficiency harness: rays/s vs mesh size (BASELINE.md: ≥0.9 linear
scaling from one device to many).

On a multi-GPU host this measures multi-card scaling (collectives over
NVLink); on a CPU box it still validates the sharded program end-to-end by
shrinking the mesh over virtual devices (numbers then reflect host
parallelism only — labeled accordingly by the recorded platform).

Usage:
    python benchmarks/scaling.py [--width 1920 --height 1080 --spp 64]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--max-depth", type=int, default=4)
    p.add_argument("--engine", default="fused",
                   choices=["fused", "wavefront"])
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args()

    import jax

    from spira_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    import spira_tpu as st
    from spira_tpu.parallel.distributed import initialize
    from spira_tpu.parallel.mesh import make_mesh, replicate
    from spira_tpu.parallel.sharded import render_flat_sharded

    initialize()
    n_dev = jax.device_count()
    backend = jax.default_backend()
    scene = st.create_scene()
    camera = st.default_camera(args.width / args.height)
    rays = args.width * args.height * args.spp * args.max_depth

    sizes = []
    n = 1
    while n <= n_dev:
        sizes.append(n)
        n *= 2

    results = []
    for n in sizes:
        # height must divide n; pad the tile count down if it does not
        if args.height % n != 0:
            print(f"skip n={n}: height {args.height} % {n} != 0",
                  file=sys.stderr)
            continue
        mesh = make_mesh(n_tile=n, n_spp=1, devices=jax.devices()[:n])
        sc = replicate(scene, mesh)
        cam = replicate(camera, mesh)

        def run(seed):
            return render_flat_sharded(
                sc, cam, width=args.width, height=args.height, mesh=mesh,
                spp=args.spp, max_depth=args.max_depth, seed=seed,
                engine=args.engine,
            )

        jax.block_until_ready(run(0))  # compile
        t0 = time.perf_counter()
        for i in range(args.iters):
            out = run(i + 1)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.iters
        rate = rays / dt
        results.append({"devices": n, "rays_per_sec": rate})
        base = results[0]["rays_per_sec"]
        eff = rate / (base * n)
        print(
            f"n={n:3d}  {rate / 1e6:10.1f} Mrays/s   "
            f"scaling efficiency {eff:.3f}",
            file=sys.stderr,
        )

    print(json.dumps({"platform": backend,
                      "device_kind": jax.devices()[0].device_kind,
                      "engine": args.engine, "results": results}))


if __name__ == "__main__":
    main()
