"""Progressive chunked rendering with metrics and checkpoint/resume.

The production driver around the jitted kernel: host loops over sample
chunks (the reference's host spp loop,
`/root/reference/src/spira-metal-optimized.jl:1274`, kept *between* device
dispatches where it belongs), reports rays/s + ETA, and persists
sample-granular checkpoints so long renders survive preemption
(SURVEY.md §5 "checkpoint/resume").  Resume is exact: the RNG is
counter-based, so samples [k, k+n) are the same paths no matter when they
are rendered.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .core import rng as srng
from .io import image as img_io
from .render import accumulate_row_set, accumulate_rows
from .utils import checkpoint as ckpt
from .utils.config import RenderConfig, build_scene
from .utils.metrics import RenderMeter, logger


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "n_samples", "max_depth", "semantics",
        "inclusive_uv", "spectral",
    ),
)
def _render_chunk(
    scene, camera, sample_offset, *, width, height, n_samples, max_depth,
    semantics, spectral, seed, inclusive_uv=True,
):
    """Sum of ``n_samples`` starting at traced ``sample_offset`` — one
    compilation serves every chunk."""
    return accumulate_rows(
        scene,
        camera,
        srng.base_key(seed),
        width=width,
        height=height,
        row_start=0,
        n_rows=height,
        sample_offset=sample_offset,
        n_samples=n_samples,
        max_depth=max_depth,
        semantics=semantics,
        inclusive_uv=inclusive_uv,
        spectral=spectral,
    )


def render_progressive(scene, camera, cfg: RenderConfig, mesh=None) -> np.ndarray:
    """Render under ``cfg`` with progress reporting and optional
    checkpointing; returns the (H, W, 3) HDR image.

    With ``mesh`` (a ``jax.sharding.Mesh`` with tile/spp axes) each chunk
    dispatches tile-sharded via
    :func:`spira_tpu.parallel.sharded.render_chunk_sharded` — the BASELINE
    config-5 shape (1920x1080 spp=256 over a chip mesh) where one program
    per chunk keeps memory bounded and checkpoints stay sample-granular.
    Chunk sizes must divide by the mesh's spp axis."""
    n = cfg.width * cfg.height
    acc = jnp.zeros((n, 3), jnp.float32)
    done = 0

    if cfg.checkpoint_dir:
        state = ckpt.load_render_state(cfg.checkpoint_dir)
        if state is not None:
            saved_acc, saved_done, saved_seed, saved_cfg = state
            if saved_cfg == cfg.to_json() and saved_seed == cfg.seed:
                acc = jnp.asarray(saved_acc)
                done = saved_done
                logger.info("resumed at sample %d/%d", done, cfg.spp)
            else:
                logger.warning(
                    "checkpoint config mismatch — starting fresh"
                )

    chunk = cfg.checkpoint_every if cfg.checkpoint_every > 0 else cfg.spp
    meter = RenderMeter(
        cfg.width, cfg.height, cfg.spp, cfg.max_depth, enabled=cfg.progress
    )
    meter.samples_done = done
    saver = ckpt.AsyncSaver()
    pending_save = None

    while done < cfg.spp:
        take = min(chunk, cfg.spp - done)
        # chunk sizes are static; at most two compilations (full + remainder)
        if mesh is not None:
            from .parallel.sharded import render_chunk_sharded

            part = render_chunk_sharded(
                scene,
                camera,
                done,
                width=cfg.width,
                height=cfg.height,
                mesh=mesh,
                n_samples=take,
                max_depth=cfg.max_depth,
                seed=cfg.seed,
                semantics=cfg.semantics,
                spectral=cfg.spectral,
            )
        else:
            part = _render_chunk(
                scene,
                camera,
                jnp.int32(done),
                width=cfg.width,
                height=cfg.height,
                n_samples=take,
                max_depth=cfg.max_depth,
                semantics=cfg.semantics,
                spectral=cfg.spectral,
                seed=cfg.seed,
            )
        acc = acc + part
        done += take
        # Submit the PREVIOUS chunk's save only now — after this chunk's
        # render is enqueued on the device — so the save's device→host
        # fetch overlaps this chunk's compute instead of idling the device.
        if pending_save is not None:
            saver.submit(ckpt.save_render_state, cfg.checkpoint_dir,
                         **pending_save)
            pending_save = None
        if cfg.checkpoint_dir and done < cfg.spp:
            pending_save = dict(
                accumulator=acc,
                samples_done=done,
                seed=cfg.seed,
                config_json=cfg.to_json(),
            )
        acc.block_until_ready()
        meter.update(done)

    if pending_save is not None:  # single-chunk tail: nothing overlapped it
        saver.submit(ckpt.save_render_state, cfg.checkpoint_dir,
                     **pending_save)
    saver.wait()
    flat = acc / jnp.float32(cfg.spp)
    return np.asarray(img_io.assemble_image(flat, cfg.width, cfg.height))


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def render_adaptive(
    scene,
    camera,
    cfg: RenderConfig,
    *,
    tol: float = 0.02,
    min_spp: int = 8,
    chunk: int = 8,
    quantile: float = 0.98,
    return_stats: bool = False,
    intersect_fn=None,
    mesh=None,
    granularity: str = "row",
    statistic: str = "auto",
):
    """Variance-guided progressive render: rows stop sampling once their
    pixels' luminance confidence intervals converge (new-build; the
    reference samples every pixel uniformly).

    Dense adaptivity: instead of per-pixel masking (which saves nothing
    on a SIMD machine — masked lanes still run), each round
    dispatches ONE dense kernel over only the rows whose error is still
    above ``tol``, via :func:`spira_tpu.render.accumulate_row_set`.  Row
    counts are padded to the next power of two so the whole render
    compiles at most ``log2(height) x 2`` programs, all cached.

    Convergence: a row retires when the ``quantile`` of its pixels'
    relative half-CI95 of mean luminance drops to ``tol`` (the quantile,
    not the max, so one firefly pixel cannot pin a row forever).
    ``cfg.spp`` is the per-row sample budget CAP; ``min_spp`` the floor
    before any row may retire.  The estimate stays a valid MC average
    (per-pixel sums / per-row counts); the stopping rule introduces the
    usual, bounded optional-stopping bias — that is the point of adaptive
    sampling, and ``tol`` bounds it.

    ``mesh`` (a tile[/spp] `jax.sharding.Mesh`) shards each round's row
    set over the tile axis and its samples over spp — adaptivity over
    several devices, with the convergence ledger on the host as before.
    ``chunk`` must divide by the spp-axis size.

    ``granularity``: the independently-retiring dispatch unit — ``"row"``
    (whole image rows, the round-≤4 behavior) or ``"block"`` (128-pixel
    row segments via :func:`spira_tpu.render.accumulate_block_set`).
    Rows proved too coarse for ``tol`` to matter: 640-pixel rows are
    heterogeneous, so their quantile-CI distributions are bimodal and
    every useful tolerance picks the same rows (round-4 battery: three
    tolerances, byte-identical savings).  Blocks are ~5x finer and
    spatially homogeneous (sky blocks retire at min_spp, silhouette
    blocks late), giving the tolerance a real operating range.

    ``statistic``: what ``tol`` bounds — ``"quantile"`` (the ``quantile``
    of the segment's per-pixel relative half-CI95; the round-≤4 rule) or
    ``"mean"`` (the relative half-CI95 of the segment's MEAN luminance).
    Per-pixel MC CIs span orders of magnitude with a gap across the
    useful band (a converged sky pixel sits at ~1e-3, any pixel with
    bounce noise at ≳0.2 even at a 64-spp cap), which is exactly the
    measured dead-knob bimodality; averaging seg_w pixels compresses the
    statistic ~sqrt(seg_w)x into the band where tolerances live, so the
    knob selects materially different operating points.  ``"auto"`` picks
    ``"mean"`` for blocks and ``"quantile"`` for rows (back-compat).

    Returns the (H, W, 3) HDR image; with ``return_stats=True`` also a
    dict with total/uniform sample counts and the per-row spp map.
    """
    W, H = cfg.width, cfg.height
    max_spp = cfg.spp
    if max_spp < 1:
        raise ValueError(f"spp must be >= 1, got {max_spp}")
    min_spp = min(min_spp, max_spp)
    base = srng.base_key(cfg.seed)

    if granularity == "block":
        if mesh is not None:
            raise NotImplementedError(
                "block-granularity adaptive sampling is single-device; "
                "use granularity='row' with a mesh"
            )
        if W % 128:
            raise ValueError(f"granularity='block' needs W % 128 == 0, "
                             f"got {W}")
        nbx, seg_w = W // 128, 128
    elif granularity == "row":
        nbx, seg_w = 1, W
    else:
        raise ValueError(f"unknown granularity {granularity!r}")
    if statistic == "auto":
        statistic = "mean" if granularity == "block" else "quantile"
    if statistic not in ("mean", "quantile"):
        raise ValueError(f"unknown statistic {statistic!r}")
    n_segs = H * nbx
    _lane = np.arange(seg_w)

    def seg_gather(arr, segs):
        """(r, seg_w) view of a per-pixel (H, W[, C]) ledger array."""
        if granularity == "row":
            return arr[segs]
        ci = (segs % nbx)[:, None] * seg_w + _lane[None, :]
        return arr[(segs // nbx)[:, None], ci]

    def seg_add(arr, segs, vals):
        """Scatter-add per-segment results into a per-pixel ledger."""
        if granularity == "row":
            arr[segs] += vals
        else:
            ci = (segs % nbx)[:, None] * seg_w + _lane[None, :]
            arr[(segs // nbx)[:, None], ci] += vals

    acc = np.zeros((H, W, 3), np.float32)
    lum = np.zeros((H, W), np.float64)
    lum2 = np.zeros((H, W), np.float64)
    counts = np.zeros((n_segs,), np.int64)

    meter = RenderMeter(W, H, max_spp, cfg.max_depth, enabled=cfg.progress)

    n_tile = mesh.shape["tile"] if mesh is not None else 1
    n_spp_axis = mesh.shape.get("spp", 1) if mesh is not None else 1
    if max_spp % n_spp_axis:
        raise ValueError(
            f"spp {max_spp} must divide by the spp axis {n_spp_axis}"
        )
    chunk = -(-chunk // n_spp_axis) * n_spp_axis  # round UP to the axis

    active = np.arange(n_segs, dtype=np.int32)
    spp_done = 0  # segments retire together, so actives share one count
    sample_base = 0

    # the stopping hyperparameters AND the mesh shape live in the manifest
    # next to the config: a resumed run must make the same retirement
    # decisions and draw the same streams (the sharded path folds tile ids
    # into keys, so a different mesh breaks bit-exact resume)
    hyper = dict(tol=tol, min_spp=min_spp, chunk=chunk, quantile=quantile,
                 mesh=[n_tile, n_spp_axis], granularity=granularity,
                 statistic=statistic)
    if cfg.checkpoint_dir:
        state = ckpt.load_adaptive_state(cfg.checkpoint_dir)
        if state is not None:
            arrays, scalars, saved_cfg = state
            if (saved_cfg == cfg.to_json()
                    and {k: scalars.get(k) for k in hyper} == hyper):
                acc, lum, lum2 = arrays["acc"], arrays["lum"], arrays["lum2"]
                counts, active = arrays["counts"], arrays["active"]
                spp_done = scalars["spp_done"]
                sample_base = scalars["sample_base"]
                logger.info(
                    "resumed adaptive at %d active rows, %d spp",
                    active.size, spp_done,
                )
            else:
                logger.warning("checkpoint config mismatch — starting fresh")
    meter.samples_done = int(counts.sum() / n_segs)

    dispatched = 0  # segment-samples actually executed, padding included
    while active.size and spp_done < max_spp:
        take = int(min(chunk, max_spp - spp_done))
        r = active.size
        # pad to n_tile * pow2 so each device takes an equal contiguous
        # slice and the whole render compiles O(log2 n_segs) programs —
        # but never past the full image (the early all-segments rounds
        # would otherwise pad 1080 -> 2048 and burn real work)
        r_pad = min(
            n_tile * _next_pow2(-(-r // n_tile)),
            n_tile * (-(-n_segs // n_tile)),
        )
        dispatched += r_pad * take
        rows = np.concatenate(
            [active, np.full(r_pad - r, int(active[0]), np.int32)]
        )
        if granularity == "block":
            from .render import accumulate_block_set

            a, l, l2 = accumulate_block_set(
                scene, camera, base, jnp.asarray(rows),
                jnp.int32(sample_base), width=W, height=H, n_samples=take,
                max_depth=cfg.max_depth, semantics=cfg.semantics,
                spectral=cfg.spectral, intersect_fn=intersect_fn,
            )
        elif mesh is not None:
            from .parallel.sharded import accumulate_row_set_sharded

            a, l, l2 = accumulate_row_set_sharded(
                scene, camera, base, jnp.asarray(rows),
                jnp.int32(sample_base), width=W, height=H, n_samples=take,
                max_depth=cfg.max_depth, mesh=mesh,
                semantics=cfg.semantics, spectral=cfg.spectral,
                intersect_fn=intersect_fn,
            )
        else:
            a, l, l2 = accumulate_row_set(
                scene,
                camera,
                base,
                jnp.asarray(rows),
                jnp.int32(sample_base),
                width=W,
                height=H,
                n_samples=take,
                max_depth=cfg.max_depth,
                semantics=cfg.semantics,
                spectral=cfg.spectral,
                intersect_fn=intersect_fn,
            )
        seg_add(acc, active, np.asarray(a).reshape(r_pad, seg_w, 3)[:r])
        seg_add(lum, active, np.asarray(l).reshape(r_pad, seg_w)[:r])
        seg_add(lum2, active, np.asarray(l2).reshape(r_pad, seg_w)[:r])
        counts[active] += take
        spp_done += take
        sample_base += take
        meter.update(int(counts.sum() / n_segs))

        if spp_done >= min_spp and spp_done > 1:
            n = float(spp_done)
            mean = seg_gather(lum, active) / n
            var = np.maximum(seg_gather(lum2, active) / n - mean * mean, 0.0)
            var *= n / (n - 1.0)
            if statistic == "mean":
                # relative half-CI95 of the segment's MEAN luminance:
                # Var(mean of seg_w independent pixel means) =
                # sum(var_i) / seg_w^2 / n
                m_seg = mean.mean(axis=1)
                se = np.sqrt(var.sum(axis=1) / n) / seg_w
                row_err = 1.96 * se / (np.abs(m_seg) + 1e-3)
            else:
                rel_ci = 1.96 * np.sqrt(var / n) / (np.abs(mean) + 1e-3)
                row_err = np.quantile(rel_ci, quantile, axis=1)
            active = active[row_err > tol]

        if cfg.checkpoint_dir and active.size and spp_done < max_spp:
            ckpt.save_adaptive_state(
                cfg.checkpoint_dir,
                arrays=dict(acc=acc, lum=lum, lum2=lum2, counts=counts,
                            active=active),
                scalars=dict(spp_done=int(spp_done),
                             sample_base=int(sample_base), **hyper),
                config_json=cfg.to_json(),
            )

    # per-pixel spp: expand the per-segment count map over its pixels
    pix_counts = np.repeat(counts.reshape(H, nbx), seg_w, axis=1)
    img = acc / pix_counts[:, :, None].astype(np.float32)
    img = img[::-1]  # bottom-up rows -> top-down image (assemble_image flip)
    if not return_stats:
        return img
    spp_map = counts.reshape(H, nbx)[::-1]  # top-down, like the image
    stats = {
        "total_samples": int(counts.sum()) * seg_w,
        # padding included: what the hardware really ran — compare THIS to
        # uniform_samples for the honest win (savings counts image samples)
        "dispatched_samples": int(dispatched) * seg_w,
        "uniform_samples": H * W * max_spp,
        "savings": 1.0 - counts.sum() * seg_w / float(H * W * max_spp),
        "dispatch_savings": 1.0 - dispatched * seg_w / float(H * W * max_spp),
        "spp_per_row": spp_map.mean(axis=1),  # per-row mean (back-compat)
        "spp_map": spp_map,  # (H, W/seg_w) per-segment counts
        "granularity": granularity,
        "tol": tol,
    }
    return img, stats


def run_config(cfg: RenderConfig) -> np.ndarray:
    """Build the scene, render (sharded if configured), tone map, save."""
    scene, camera = build_scene(cfg)

    if cfg.shading != "full":
        from .integrator.preview import render_flat_preview

        flat = render_flat_preview(
            scene, camera, width=cfg.width, height=cfg.height,
            seed=cfg.seed, shading=cfg.shading,
        )
        hdr = np.asarray(img_io.assemble_image(flat, cfg.width, cfg.height))
        ldr = img_io.TONEMAPS[cfg.tonemap](jnp.asarray(hdr))
        out = img_io.to_uint8(ldr)
        if cfg.output:
            img_io.save_png(cfg.output, out)
            logger.info("wrote %s", cfg.output)
        return out

    if cfg.engine != "auto" and (
        cfg.n_tile is not None or cfg.checkpoint_dir or cfg.checkpoint_every > 0
        or cfg.adaptive_tol is not None
    ):
        logger.warning(
            "--engine %s is ignored by the sharded/progressive/adaptive "
            "drivers (wavefront family only — they need sample offsets)",
            cfg.engine,
        )
    if cfg.adaptive_tol is not None:
        mesh = None
        if cfg.n_tile is not None:
            from .parallel.mesh import make_mesh, replicate

            mesh = make_mesh(n_tile=cfg.n_tile, n_spp=cfg.n_spp_axis)
            scene = replicate(scene, mesh)
            camera = replicate(camera, mesh)
        gran = cfg.adaptive_granularity
        if mesh is not None or cfg.width % 128:
            gran = "row"  # block sets are single-device, width-128-aligned
        hdr, stats = render_adaptive(
            scene, camera, cfg, tol=cfg.adaptive_tol,
            min_spp=cfg.adaptive_min_spp, mesh=mesh, return_stats=True,
            granularity=gran,
        )
        logger.info(
            "adaptive: %.0f%% of uniform %d spp (%d samples saved)",
            100.0 * (1.0 - stats["savings"]), cfg.spp,
            stats["uniform_samples"] - stats["total_samples"],
        )
    elif cfg.n_tile is not None:
        from .parallel.mesh import make_mesh, replicate
        from .parallel.sharded import render_flat_sharded

        mesh = make_mesh(n_tile=cfg.n_tile, n_spp=cfg.n_spp_axis)
        scene = replicate(scene, mesh)
        camera = replicate(camera, mesh)
        if cfg.checkpoint_every > 0 or cfg.checkpoint_dir:
            # config-5 shape: spp-chunked + checkpointed, each chunk sharded
            hdr = render_progressive(scene, camera, cfg, mesh=mesh)
        else:
            flat = render_flat_sharded(
                scene,
                camera,
                width=cfg.width,
                height=cfg.height,
                mesh=mesh,
                spp=cfg.spp,
                max_depth=cfg.max_depth,
                seed=cfg.seed,
                semantics=cfg.semantics,
                spectral=cfg.spectral,
            )
            hdr = np.asarray(
                img_io.assemble_image(flat, cfg.width, cfg.height)
            )
    elif cfg.checkpoint_dir or cfg.checkpoint_every > 0:
        hdr = render_progressive(scene, camera, cfg)
    else:
        # single dispatch through the engine dispatcher — the fused
        # engines serve qualifying scenes (the progressive/chunked
        # driver above stays on the wavefront family, which supports
        # sample offsets for exact resume)
        from .render import render_flat_engine

        flat = render_flat_engine(
            scene,
            camera,
            width=cfg.width,
            height=cfg.height,
            spp=cfg.spp,
            max_depth=cfg.max_depth,
            seed=cfg.seed,
            semantics=cfg.semantics,
            spectral=cfg.spectral,
            engine=cfg.engine,
        )
        hdr = np.asarray(img_io.assemble_image(flat, cfg.width, cfg.height))

    ldr = img_io.TONEMAPS[cfg.tonemap](jnp.asarray(hdr))
    out = img_io.to_uint8(ldr)
    if cfg.output:
        if cfg.output.endswith(".exr"):
            img_io.save_exr(cfg.output, hdr)
        elif cfg.output.endswith(".ppm"):
            img_io.save_ppm(cfg.output, out)
        else:
            img_io.save_png(cfg.output, out)
        logger.info("wrote %s", cfg.output)
    return out
