"""Headline benchmark: rays/sec on one GPU, forward+backward, at the
reference's flagship config (640×360, spp=16, max_depth=4 — BASELINE.md
primary metric).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras},
with the platform, device kind, device count, card name and power limit.

"Rays" counts traced path segments in the forward estimator
(W·H·spp·max_depth); the timed region is a full differentiable step
(:func:`make_step`) — forward render, MSE loss against a target image, and
gradients w.r.t. all material parameters (the inverse-rendering workload,
BASELINE.json config 4).

The headline ``value`` is the EXACT-replay number (backward replays all spp
samples).  The grad_spp=4 stochastic-subsampled estimator — unbiased, ~4×
less backward work, the practical inverse-rendering configuration — is
reported alongside (``subsampled_grad_spp4``), with the forward engines.

vs_baseline: the reference publishes no measured numbers
(BASELINE.json.published == {}); its only quantitative claim is "10–50×
faster than CPU" for its Metal GPU path.  We peg the baseline at 1e7
segments/s — a mid-range estimate of that claimed GPU-class throughput
(CPU path tracers of this complexity run ~0.2–1 Mrays/s/core) — so
vs_baseline = value / 1e7.

Without a GPU the script exits non-zero and prints no record; so does any
failing tier.  Run: ``python bench.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

BASELINE_RAYS_PER_SEC = 1.0e7

WIDTH, HEIGHT, SPP, MAX_DEPTH = 640, 360, 16, 4
FLAGSHIP = dict(width=WIDTH, height=HEIGHT, spp=SPP, max_depth=MAX_DEPTH)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_step(scene, camera, target, *, grad_spp, **kw):
    """The flagship fwd+bwd step: `render_flat_hybrid_grad` → MSE against
    ``target`` → `value_and_grad` over the materials.  Returns the jitted
    ``step(materials, seed) -> (loss, grads)``."""
    import jax
    import jax.numpy as jnp

    from spira_tpu.core.types import replace
    from spira_tpu.kernels.megakernel import render_flat_hybrid_grad

    @jax.jit
    def step(materials, seed):
        def loss_fn(m):
            img = render_flat_hybrid_grad(
                replace(scene, materials=m), camera, seed=seed,
                grad_spp=grad_spp, **kw,
            )
            return jnp.mean((img - target) ** 2)

        return jax.value_and_grad(loss_fn)(materials)

    return step


def _time(fn, iters):
    """Seconds per call of ``fn(i)`` after one warm-up (compile) call."""
    import jax

    jax.block_until_ready(fn(0))
    t0 = time.perf_counter()
    out = None
    for i in range(iters):
        out = fn(i + 1)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main() -> None:
    import jax
    import jax.numpy as jnp

    from spira_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform!r}")

    import spira_tpu as st
    from spira_tpu.kernels.megakernel import (
        render_flat_fused,
        render_flat_megakernel,
    )
    from spira_tpu.render import engine_row, render_flat

    scene = st.create_scene()
    camera = st.default_camera(WIDTH / HEIGHT)
    rays = WIDTH * HEIGHT * SPP * MAX_DEPTH
    target = render_flat_fused(scene, camera, **FLAGSHIP, seed=7)

    step_exact = make_step(scene, camera, target, grad_spp=SPP, **FLAGSHIP)
    step_sub = make_step(scene, camera, target, grad_spp=4, **FLAGSHIP)
    dt_exact = _time(lambda i: step_exact(scene.materials, jnp.int32(i)), 20)
    dt_sub = _time(lambda i: step_sub(scene.materials, jnp.int32(i)), 20)
    loss, grads = step_exact(scene.materials, jnp.int32(0))
    if not all(bool(jnp.isfinite(x).all())
               for x in jax.tree_util.tree_leaves((loss, grads))):
        sys.exit("bench.py: non-finite loss or gradient")

    fwd = {
        "pallas": lambda i: render_flat_megakernel(
            scene, camera, **FLAGSHIP, seed=i),
        "fused": lambda i: render_flat_fused(scene, camera, **FLAGSHIP,
                                             seed=i),
        "wavefront": lambda i: render_flat(scene, camera, **FLAGSHIP,
                                           seed=i),
    }
    fwd_ms = {name: round(_time(fn, 20) * 1e3, 4) for name, fn in fwd.items()}

    rays_per_sec = rays / dt_exact
    record = {
        "metric": "rays/sec/chip fwd+bwd (exact replay) at 640x360 spp=16 "
                  "depth=4",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / BASELINE_RAYS_PER_SEC, 3),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card(),
        "engine": f"hybrid {engine_row()['small']}-fwd/fused-bwd",
        "step_ms": round(dt_exact * 1e3, 4),
        "inverse_iters_per_sec": round(1.0 / dt_exact, 2),
        "subsampled_grad_spp4": round(rays / dt_sub, 1),
        "subsampled_step_ms": round(dt_sub * 1e3, 4),
        "fwd_ms": fwd_ms,
        "loss": float(loss),
    }
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
