"""Differentiable inverse rendering: recover material parameters by gradient
descent on image loss (BASELINE.json config 4: "recover albedo SPDs + light
emission via path-replay gradients, Adam loop").

The reference has **no autodiff** (SURVEY.md §0) — this subsystem is
new-build.  The whole estimator is written in differentiable JAX; the
sampling *decisions* (lobe choice, RR) are detached so gradients flow only
through the continuous factors (throughput products, emission adds).  The
per-sample loop is wrapped in `jax.checkpoint`: the backward pass re-traces
each path from its RNG counters instead of storing the per-bounce tape —
path replay by rematerialization.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import optax

from ..core import rng as srng
from ..core.types import replace
from ..render import accumulate_rows


def render_for_grad(
    params,
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed,
    semantics: str = "physical",
    spectral: bool = False,
    mesh=None,
):
    """Differentiable render of `scene` with material overrides from
    ``params`` (a dict of Materials field overrides, e.g. albedo/emission).

    When ``mesh`` is given, the ray axis is tile-sharded and samples are
    spp-sharded exactly like the forward renderer; XLA inserts the gradient
    all-reduce (`psum` between devices) for the replicated parameters in
    the backward pass.
    """
    materials = scene.materials
    for name, value in params.items():
        materials = replace(materials, **{name: value})
    scene = replace(scene, materials=materials)

    base = srng.base_key(0)
    base = jax.random.fold_in(base, seed)

    if mesh is None:
        n_rows, spp_per = height, spp
    else:
        n_rows = height // mesh.shape["tile"]
        spp_per = spp // mesh.shape.get("spp", 1)

    # Per-sample and per-bounce checkpointing (path-replay backprop) lives
    # inside accumulate_rows/trace; this wrapper only fixes the static config.
    def ckpt_accumulate(scene, camera, base_key, row_start, sample_offset):
        return accumulate_rows(
            scene,
            camera,
            base_key,
            width=width,
            height=height,
            row_start=row_start,
            n_rows=n_rows,
            sample_offset=sample_offset,
            n_samples=spp_per,
            max_depth=max_depth,
            semantics=semantics,
            spectral=spectral,
        )

    if mesh is None:
        acc = ckpt_accumulate(scene, camera, base, 0, 0)
        return acc / jnp.float32(spp)

    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    def shard_body(scene, camera):
        t = jax.lax.axis_index("tile")
        s = jax.lax.axis_index("spp")
        acc = ckpt_accumulate(scene, camera, base, t * n_rows, s * spp_per)
        return jax.lax.psum(acc, "spp") / jnp.float32(spp)

    return shard_map(
        shard_body, mesh=mesh, in_specs=(P(), P()), out_specs=P("tile"),
    )(scene, camera)


def mse_loss(rendered, target):
    return jnp.mean((rendered - target) ** 2)


@lru_cache(maxsize=32)
def _make_step(optimizer, width, height, spp, max_depth, semantics,
               spectral, mesh):
    def loss_fn(params, scene, camera, target, step_idx):
        img = render_for_grad(
            params,
            scene,
            camera,
            width=width,
            height=height,
            spp=spp,
            max_depth=max_depth,
            seed=step_idx,
            semantics=semantics,
            spectral=spectral,
            mesh=mesh,
        )
        return mse_loss(img, target)

    @jax.jit
    def step(params, opt_state, scene, camera, target, step_idx):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, scene, camera, target, step_idx
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        # Parameters live in [0, ∞) (albedo/reflectance additionally in
        # [0, 1]); simple projection keeps Adam iterates physical and curbs
        # drift along metamer directions for SPD tables.
        if "albedo" in params:
            params = dict(params, albedo=jnp.clip(params["albedo"], 0.0, 1.0))
        if "albedo_spd" in params:
            params = dict(
                params, albedo_spd=jnp.clip(params["albedo_spd"], 0.0, 1.0)
            )
        if "emission" in params:
            params = dict(
                params, emission=jnp.maximum(params["emission"], 0.0)
            )
        if "emission_spd" in params:
            params = dict(
                params, emission_spd=jnp.maximum(params["emission_spd"], 0.0)
            )
        return params, opt_state, loss

    return step


def make_inverse_step(
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    semantics: str = "physical",
    spectral: bool = False,
    learning_rate: float = 2e-2,
    mesh=None,
    optimizer=None,
):
    """Build (step_fn, init_fn) for the Adam inverse-rendering loop.

    step_fn(params, opt_state, scene, camera, target, step_idx) →
    (params, opt_state, loss).  ``params`` is a dict of Materials field
    overrides; each step uses a fresh MC seed (step_idx) — stochastic
    gradient descent over renders.
    """
    if optimizer is None:
        optimizer = optax.adam(learning_rate)
    step = _make_step(
        optimizer, width, height, spp, max_depth, semantics, spectral, mesh,
    )

    def init(params):
        return optimizer.init(params)

    return step, init
