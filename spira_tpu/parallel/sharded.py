"""Tile- and sample-sharded rendering over a device mesh.

New-build territory per SURVEY.md §2.8 (the reference is single-device): the
image's pixel rows are sharded over the ``tile`` mesh axis, Monte-Carlo
samples over the ``spp`` axis; the scene pytree is replicated.  The per-shard
body is the same `accumulate_rows` loop as the single-chip renderer — the
only collective is one `psum` (mean over the sample axis), which XLA hands
to NCCL between cards.

The per-bounce host sync of the reference wavefront driver
(`/root/reference/src/spira-metal-optimized.jl:1309`) has no analogue here:
all control flow stays on device, shards never communicate during tracing.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core import rng as srng
from ..io import image as img_io
from ..render import accumulate_rows


def _check_engine(engine: str):
    if engine not in ("fused", "wavefront"):
        raise ValueError(
            f"sharded engine must be 'fused' or 'wavefront', got {engine!r}"
        )


@lru_cache(maxsize=64)
def _make_sharded_renderer(
    width, height, mesh, spp, max_depth, seed, semantics, inclusive_uv,
    spectral, engine,
):
    _check_engine(engine)
    n_tile = mesh.shape["tile"]
    n_spp_axis = mesh.shape.get("spp", 1)
    if height % n_tile != 0:
        raise ValueError(f"height {height} not divisible by tile axis {n_tile}")
    if spp % n_spp_axis != 0:
        raise ValueError(f"spp {spp} not divisible by spp axis {n_spp_axis}")
    rows_per = height // n_tile
    spp_per = spp // n_spp_axis

    def shard_body(scene, camera):
        t = jax.lax.axis_index("tile")
        s = jax.lax.axis_index("spp")
        if engine == "fused":
            from ..kernels.megakernel import fused_rows

            acc = fused_rows(
                scene,
                camera,
                width=width,
                n_rows=rows_per,
                row_start=t * rows_per,
                sample_offset=s * spp_per,
                spp=spp_per,
                max_depth=max_depth,
                seed=seed,
                du=float(width - 1 if inclusive_uv else width),
                dv=float(height - 1 if inclusive_uv else height),
            )
            return jax.lax.psum(acc, "spp") / jnp.float32(spp)
        acc = accumulate_rows(
            scene,
            camera,
            srng.base_key(seed),
            width=width,
            height=height,
            row_start=t * rows_per,
            n_rows=rows_per,
            sample_offset=s * spp_per,
            n_samples=spp_per,
            max_depth=max_depth,
            semantics=semantics,
            inclusive_uv=inclusive_uv,
            spectral=spectral,
        )
        # Mean over every sample on every spp-shard: one all-reduce.
        return jax.lax.psum(acc, "spp") / jnp.float32(spp)

    return jax.jit(
        shard_map(shard_body, mesh=mesh, in_specs=(P(), P()),
                  out_specs=P("tile"))
    )


@lru_cache(maxsize=64)
def _make_sharded_chunk(
    width, height, mesh, n_samples, max_depth, seed, semantics, inclusive_uv,
    spectral, engine,
):
    """Like `_make_sharded_renderer` but renders ``n_samples`` starting at a
    *traced* global sample offset and returns the radiance **sum** (no mean)
    — the shard body of the progressive/checkpointed multi-chip driver
    (BASELINE config 5: 1920x1080 spp=256 cannot dispatch in one program)."""
    _check_engine(engine)
    n_tile = mesh.shape["tile"]
    n_spp_axis = mesh.shape.get("spp", 1)
    if height % n_tile != 0:
        raise ValueError(f"height {height} not divisible by tile axis {n_tile}")
    if n_samples % n_spp_axis != 0:
        raise ValueError(
            f"chunk {n_samples} not divisible by spp axis {n_spp_axis}"
        )
    rows_per = height // n_tile
    spp_per = n_samples // n_spp_axis

    def shard_body(scene, camera, sample_offset):
        t = jax.lax.axis_index("tile")
        s = jax.lax.axis_index("spp")
        offset = sample_offset + s * spp_per
        if engine == "fused":
            from ..kernels.megakernel import fused_rows

            acc = fused_rows(
                scene, camera, width=width, n_rows=rows_per,
                row_start=t * rows_per, sample_offset=offset, spp=spp_per,
                max_depth=max_depth, seed=seed,
                du=float(width - 1 if inclusive_uv else width),
                dv=float(height - 1 if inclusive_uv else height),
            )
        else:
            acc = accumulate_rows(
                scene, camera, srng.base_key(seed), width=width,
                height=height, row_start=t * rows_per, n_rows=rows_per,
                sample_offset=offset, n_samples=spp_per, max_depth=max_depth,
                semantics=semantics, inclusive_uv=inclusive_uv,
                spectral=spectral,
            )
        return jax.lax.psum(acc, "spp")

    return jax.jit(
        shard_map(
            shard_body, mesh=mesh, in_specs=(P(), P(), P()),
            out_specs=P("tile"),
        )
    )


def render_chunk_sharded(
    scene, camera, sample_offset, *, width, height, mesh, n_samples,
    max_depth=4, seed=0, semantics="physical", inclusive_uv=True,
    spectral=False, engine="wavefront",
):
    """Radiance **sum** of global samples [offset, offset+n_samples) as a
    tile-sharded flat (H*W, 3) buffer.  Because randomness is keyed on
    absolute sample indices, summing chunks reproduces the one-shot render
    regardless of chunking or mesh shape."""
    fn = _make_sharded_chunk(
        width, height, mesh, n_samples, max_depth, seed, semantics,
        inclusive_uv, spectral, engine,
    )
    return fn(scene, camera, jnp.int32(sample_offset))


def render_flat_sharded(
    scene,
    camera,
    *,
    width: int,
    height: int,
    mesh: Mesh,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    semantics: str = "physical",
    inclusive_uv: bool = True,
    spectral: bool = False,
    engine: str = "wavefront",
):
    """Render to a flat (H*W, 3) HDR buffer, sharded over ``mesh``.

    ``engine="fused"`` runs the fused megakernel tracer per shard (sphere
    scenes, physical semantics) — the multi-device fast path; images are
    sharding-invariant because randomness is keyed on global pixel ids and
    absolute sample indices.  ``"wavefront"`` runs the general estimator
    (meshes, spectral, reference semantics).

    ``height`` must divide by the tile-axis size and ``spp`` by the spp-axis
    size (pad upstream if needed).  The returned array is laid out with
    `P('tile')` on the ray axis.
    """
    fn = _make_sharded_renderer(
        width, height, mesh, spp, max_depth, seed, semantics, inclusive_uv,
        spectral, engine,
    )
    return fn(scene, camera)


def render_hdr_sharded(scene, camera, width, height, mesh, **kw):
    flat = render_flat_sharded(
        scene, camera, width=width, height=height, mesh=mesh, **kw
    )
    return img_io.assemble_image(flat, width, height)


@lru_cache(maxsize=64)
def _make_row_set_renderer(
    width, height, mesh, n_samples, max_depth, semantics, spectral,
    intersect_fn,
):
    """Sharded analogue of `render.accumulate_row_set`: the adaptive
    sampler's per-round dispatch with its (r_pad,) row set split over the
    ``tile`` axis and samples over ``spp`` (one psum per power sum).  The
    tile index is folded into the key so shards draw decorrelated
    randomness (same convention as the accumulate_rows shard body)."""
    from ..render import accumulate_row_set

    n_spp = mesh.shape.get("spp", 1)
    if n_samples % n_spp:
        raise ValueError(
            f"round size {n_samples} not divisible by spp axis {n_spp}"
        )
    per_spp = n_samples // n_spp

    def shard_body(scene, camera, rows, base_key, sample_base):
        t = jax.lax.axis_index("tile")
        s = jax.lax.axis_index("spp")
        key = jax.random.fold_in(base_key, t)
        acc, lum, lum2 = accumulate_row_set(
            scene, camera, key, rows, sample_base + s * per_spp,
            width=width, height=height, n_samples=per_spp,
            max_depth=max_depth, semantics=semantics, spectral=spectral,
            intersect_fn=intersect_fn,
        )
        return (
            jax.lax.psum(acc, "spp"),
            jax.lax.psum(lum, "spp"),
            jax.lax.psum(lum2, "spp"),
        )

    return jax.jit(
        shard_map(
            shard_body, mesh=mesh,
            in_specs=(P(), P(), P("tile"), P(), P()),
            out_specs=(P("tile"), P("tile"), P("tile")),
        )
    )


def accumulate_row_set_sharded(
    scene, camera, base_key, rows, sample_base, *, width, height, n_samples,
    max_depth, mesh, semantics="physical", spectral=False, intersect_fn=None,
):
    """Sum ``n_samples`` estimates for a row SET over a device mesh.

    ``rows`` length must divide by the tile axis; returns the same
    ``(acc, lum, lum2)`` triple as the single-device accumulate_row_set
    (tile-sharded on the row axis).
    """
    if rows.shape[0] % mesh.shape["tile"]:
        raise ValueError(
            f"row set {rows.shape[0]} not divisible by tile axis "
            f"{mesh.shape['tile']}"
        )
    fn = _make_row_set_renderer(
        width, height, mesh, n_samples, max_depth, semantics, spectral,
        intersect_fn,
    )
    return fn(scene, camera, rows, base_key, jnp.int32(sample_base))
