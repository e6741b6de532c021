"""Top-level render drivers — the package-API equivalent of
`SPIRA.render` (`/root/reference/src/spira-metal-optimized.jl:1453-1490`).

Backend selection (the reference's Metal→CUDA→CPU probe chain,
`:16-279,1460-1479`) collapses to one table keyed by the platform
`jax.devices()` provides (:data:`ENGINE_TABLE`).  The host-side samples
loop of the reference (`:1274`) becomes an on-device `lax.scan` with an
accumulator carry — one dispatch renders the whole frame.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .core import rng as srng
from .integrator.path_trace import trace
from .integrator.spectral import trace_spectral
from .io import image as img_io
from .scene.camera import generate_rays


@partial(
    jax.jit,
    static_argnames=(
        "width",
        "height",
        "spp",
        "max_depth",
        "semantics",
        "inclusive_uv",
        "spectral",
    ),
)
def render_flat(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    semantics: str = "physical",
    inclusive_uv: bool = True,
    spectral: bool = False,
):
    """Render to a flat (H*W, 3) bottom-up HDR radiance buffer (mean of spp).

    Fully on-device: `lax.scan` over samples, each sample generating and
    tracing a (H*W,) ray wavefront.  Mesh scenes intersect through the
    stackless BVH walk (`accel/traverse.py`).
    """
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    base = srng.base_key(seed)
    return accumulate_rows(
        scene,
        camera,
        base,
        width=width,
        height=height,
        row_start=0,
        n_rows=height,
        sample_offset=0,
        n_samples=spp,
        max_depth=max_depth,
        semantics=semantics,
        inclusive_uv=inclusive_uv,
        spectral=spectral,
    ) / jnp.float32(spp)


def accumulate_rows(
    scene,
    camera,
    base_key,
    *,
    width: int,
    height: int,
    row_start,
    n_rows: int,
    sample_offset,
    n_samples: int,
    max_depth: int,
    semantics: str,
    inclusive_uv: bool = True,
    spectral: bool = False,
    intersect_fn=None,
):
    """Sum ``n_samples`` radiance estimates for a row-range of the image.

    The shared inner loop of the single-chip and tile-sharded renderers:
    ``row_start`` and ``sample_offset`` may be traced (they come from
    `lax.axis_index` under `shard_map`); ``row_start`` is folded into the
    per-sample key so tiles draw decorrelated randomness.  Returns the
    *sum* over samples, shape (n_rows*width, 3) — callers divide by total spp
    (and `psum` over a sample-sharded mesh axis, the DP analogue of
    SURVEY.md §2.8).
    """

    # Each sample is its own checkpoint region: reverse-mode keeps one (N,3)
    # accumulator per sample and replays the sample's paths for its gradient.
    @jax.checkpoint
    def sample_step(acc, k):
        sample_idx = sample_offset + k
        skey = srng.sample_key(base_key, sample_idx)
        skey = jax.random.fold_in(skey, row_start)
        origins, dirs = generate_rays(
            camera,
            width,
            height,
            skey,
            inclusive_uv=inclusive_uv,
            row_start=row_start,
            n_rows=n_rows,
        )
        if spectral:
            radiance = trace_spectral(
                scene, origins, dirs, skey, max_depth=max_depth,
                intersect_fn=intersect_fn,
            )
        else:
            radiance = trace(
                scene, origins, dirs, skey, max_depth=max_depth,
                semantics=semantics, intersect_fn=intersect_fn,
            )
        return acc + radiance, None

    # `+ 0*(row_start + sample_offset)` gives the init accumulator the same
    # varying-over-mesh-axes type as the loop output when those offsets come
    # from lax.axis_index under shard_map (no-op arithmetic, folded by XLA).
    init = jnp.zeros((n_rows * width, 3), jnp.float32) + jnp.float32(0) * (
        row_start + sample_offset
    )
    acc, _ = jax.lax.scan(sample_step, init, jnp.arange(n_samples))
    return acc


#: Rec.709 luma weights — the adaptive sampler's convergence statistic.
_LUMA = jnp.asarray([0.2126, 0.7152, 0.0722], jnp.float32)
#: Float32 products on the render path ask for full precision: a GPU would
#: otherwise run them in TF32 and keep about three digits.
_HIGHEST = jax.lax.Precision.HIGHEST


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "n_samples", "max_depth", "semantics",
        "inclusive_uv", "spectral", "intersect_fn",
    ),
)
def accumulate_row_set(
    scene,
    camera,
    base_key,
    rows,
    sample_base,
    *,
    width: int,
    height: int,
    n_samples: int,
    max_depth: int,
    semantics: str = "physical",
    inclusive_uv: bool = True,
    spectral: bool = False,
    intersect_fn=None,
):
    """Sum ``n_samples`` radiance estimates for an arbitrary row SET.

    The adaptive sampler's dispatch unit: ``rows`` is an (R,) int32 array
    (traced; R static) of image rows that have not converged yet, and
    ``sample_base`` a monotone global sample counter — keys are
    ``sample_key(base, sample_base + k)``, fresh every round, shared by all
    rows of the round (rays decorrelate by array position inside the draw,
    exactly like tiles of one dispatch elsewhere).

    Returns ``(acc (R*W, 3), lum (R*W,), lum2 (R*W,))`` — radiance sum plus
    the luminance power sums the convergence test needs (Welford via
    sum/sum-of-squares; fp32 is plenty for spp <= a few thousand).
    """

    @jax.checkpoint
    def sample_step(carry, k):
        acc, lum, lum2 = carry
        skey = srng.sample_key(base_key, sample_base + k)
        origins, dirs = generate_rays(
            camera, width, height, skey, inclusive_uv=inclusive_uv,
            rows=rows,
        )
        if spectral:
            radiance = trace_spectral(
                scene, origins, dirs, skey, max_depth=max_depth,
                intersect_fn=intersect_fn,
            )
        else:
            radiance = trace(
                scene, origins, dirs, skey, max_depth=max_depth,
                semantics=semantics, intersect_fn=intersect_fn,
            )
        y = jnp.dot(radiance, _LUMA, precision=_HIGHEST)
        return (acc + radiance, lum + y, lum2 + y * y), None

    n = int(rows.shape[0]) * width
    # the no-op term types the init as varying over the mesh axes that
    # ``rows`` and ``sample_base`` vary over under shard_map (see
    # accumulate_rows)
    zero1 = jnp.zeros((n,), jnp.float32) + jnp.float32(0) * (
        rows[0] + sample_base
    )
    zero3 = jnp.zeros((n, 3), jnp.float32) + zero1[:, None]
    (acc, lum, lum2), _ = jax.lax.scan(
        sample_step, (zero3, zero1, zero1), jnp.arange(n_samples)
    )
    return acc, lum, lum2


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "n_samples", "max_depth", "semantics",
        "inclusive_uv", "spectral", "intersect_fn", "block_w",
    ),
)
def accumulate_block_set(
    scene,
    camera,
    base_key,
    blocks,
    sample_base,
    *,
    width: int,
    height: int,
    n_samples: int,
    max_depth: int,
    semantics: str = "physical",
    inclusive_uv: bool = True,
    spectral: bool = False,
    intersect_fn=None,
    block_w: int = 128,
):
    """Sum ``n_samples`` radiance estimates for an arbitrary SET of
    ``block_w``-pixel row segments (the fine-granularity twin of
    :func:`accumulate_row_set` — the round-5 adaptive sampler's dispatch
    unit, so 128-pixel blocks retire independently instead of whole rows).

    Returns ``(acc (B*block_w, 3), lum (B*block_w,), lum2 (B*block_w,))``.
    """

    @jax.checkpoint
    def sample_step(carry, k):
        acc, lum, lum2 = carry
        skey = srng.sample_key(base_key, sample_base + k)
        origins, dirs = generate_rays(
            camera, width, height, skey, inclusive_uv=inclusive_uv,
            blocks=blocks, block_w=block_w,
        )
        if spectral:
            radiance = trace_spectral(
                scene, origins, dirs, skey, max_depth=max_depth,
                intersect_fn=intersect_fn,
            )
        else:
            radiance = trace(
                scene, origins, dirs, skey, max_depth=max_depth,
                semantics=semantics, intersect_fn=intersect_fn,
            )
        y = jnp.dot(radiance, _LUMA, precision=_HIGHEST)
        return (acc + radiance, lum + y, lum2 + y * y), None

    n = int(blocks.shape[0]) * block_w
    zero3 = jnp.zeros((n, 3), jnp.float32)
    zero1 = jnp.zeros((n,), jnp.float32)
    (acc, lum, lum2), _ = jax.lax.scan(
        sample_step, (zero3, zero1, zero1), jnp.arange(n_samples)
    )
    return acc, lum, lum2


#: The engine ``"auto"`` resolves to, by platform and scene kind.  A scene
#: is ``small`` when the fused tracers take it (spheres plus at most
#: ``FUSED_TRI_LIMIT`` triangles, no BVH, physical semantics) and renders
#: RGB, ``small_spectral`` when such a scene renders spectrally, and
#: ``general`` otherwise (meshes, reference semantics).  On the GPU the
#: RGB megakernel runs as a Triton kernel; the spectral tracer stays fused
#: XLA, which measured faster than its Triton form (PERF.md).
ENGINE_TABLE = {
    "gpu": {"small": "pallas", "small_spectral": "fused",
            "general": "wavefront"},
    "cpu": {"small": "fused", "small_spectral": "fused",
            "general": "wavefront"},
}

#: Every engine a caller may name.
ENGINES = ("pallas", "fused", "wavefront")


def engine_row(platform: str | None = None) -> dict:
    """The :data:`ENGINE_TABLE` row of ``platform`` (default: JAX's
    backend).  A platform with no row is an error, not a default."""
    platform = platform or jax.default_backend()
    if platform not in ENGINE_TABLE:
        raise ValueError(
            f"no engine row for platform {platform!r} "
            f"(known: {sorted(ENGINE_TABLE)})"
        )
    return ENGINE_TABLE[platform]


def select_engine(
    scene, semantics: str, spectral: bool, engine: str = "auto",
    platform: str | None = None,
):
    """Resolve the execution engine.

    * ``pallas``    — the fused tracer as one Pallas kernel through Triton
      (small scenes, physical semantics, RGB)
    * ``fused``     — the same tracer as one XLA computation (any backend,
      differentiable)
    * ``wavefront`` — the general masked-scan estimator (triangle meshes
      through the BVH, spectral transport, reference semantics, gradients
      with overrides)

    ``auto`` looks the scene's kind up in :data:`ENGINE_TABLE`.
    """
    if engine != "auto":
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} (known: {ENGINES})")
        return engine
    from .kernels.megakernel import FUSED_TRI_LIMIT

    # thin-lens cameras stay on the fused engines: trace_tile's raygen
    # samples the lens disk from the raygen draw's spare PCG outputs
    small = (
        scene.bvh is None
        and scene.triangles.count <= FUSED_TRI_LIMIT
        and (scene.spheres.count + scene.triangles.count) > 0
        and semantics == "physical"
    )
    kind = ("small_spectral" if spectral else "small") if small else "general"
    return engine_row(platform)[kind]


def render_flat_engine(
    scene, camera, *, width, height, spp=16, max_depth=4, seed=0,
    semantics="physical", inclusive_uv=True, spectral=False, engine="auto",
):
    """render_flat with engine dispatch (same estimator family; the fused
    engines use the PCG4D RNG stream, the wavefront engine threefry — images
    agree statistically, not bitwise)."""
    engine = select_engine(scene, semantics, spectral, engine)
    kw = dict(width=width, height=height, spp=spp, max_depth=max_depth,
              seed=seed, inclusive_uv=inclusive_uv)
    if engine in ("pallas", "fused"):
        if semantics != "physical":
            raise ValueError(
                f"engine {engine!r} renders physical semantics only; use "
                "'wavefront' (or 'auto') for reference semantics"
            )
        if spectral:
            if engine == "pallas":
                raise ValueError(
                    "engine 'pallas' renders RGB only; spectral small "
                    "scenes use 'fused'"
                )
            from .kernels.spectral_fused import render_flat_fused_spectral

            return render_flat_fused_spectral(scene, camera, **kw)
        from .kernels.megakernel import (
            render_flat_fused,
            render_flat_megakernel,
        )

        fn = render_flat_megakernel if engine == "pallas" else render_flat_fused
        return fn(scene, camera, **kw)
    return render_flat(
        scene, camera, semantics=semantics, spectral=spectral, **kw
    )


# ----------------------------------------------------------------------------
# Hybrid differentiable MESH render: full-spp forward, grad_spp backward
# ----------------------------------------------------------------------------

from functools import lru_cache as _lru_cache


@_lru_cache(maxsize=None)
def _hybrid_mesh_vjp_fn(width, height, spp, grad_spp, max_depth,
                        inclusive_uv, spectral=False):
    """custom_vjp closure over the static render config (cached per config).

    Forward renders ``spp`` samples on the engine table's ``general``
    engine (the wavefront estimator); backward replays the first
    ``grad_spp`` of them through the wavefront's VJP.  Intersection is the
    stackless BVH walk with a differentiable winner recompute, so
    gradients flow to materials, camera and geometry.  With ``grad_spp ==
    spp`` the backward is the exact gradient of the forward sample; with
    fewer it is the unbiased subsampled estimator.
    """
    kw = dict(width=width, height=height, max_depth=max_depth,
              inclusive_uv=inclusive_uv, semantics="physical",
              spectral=spectral)

    @jax.custom_vjp
    def f(scene, camera, seed):
        return render_flat(scene, camera, spp=spp, seed=seed, **kw)

    def fwd(scene, camera, seed):
        return f(scene, camera, seed), (scene, camera, seed)

    def bwd(res, g):
        scene, camera, seed = res

        def replay(sc, cam):
            return render_flat(sc, cam, spp=grad_spp, seed=seed, **kw)

        _, vjp = jax.vjp(replay, scene, camera)
        d_scene, d_camera = vjp(g)
        return d_scene, d_camera, np.zeros((), jax.dtypes.float0)

    f.defvjp(fwd, bwd)
    return f


def render_flat_hybrid_grad_mesh(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    grad_spp: int | None = None,
    inclusive_uv: bool = True,
    spectral: bool = False,
):
    """Differentiable MESH render with a cheaper backward.

    Forward: the wavefront estimator at ``spp`` samples.  Backward: its VJP
    over ``grad_spp`` samples (default: ``spp``), through a stop-gradient
    traversal + differentiable winner recompute — so material, camera AND
    geometry gradients flow for arbitrarily large meshes.  Extends
    BASELINE's "pixel gradients w.r.t. material SPDs, geometry, and
    camera" to meshes (the reference has no differentiable path at all).

    ``spectral=True``: the SPECTRAL mesh hybrid — gradients flow to the
    material SPD tables, camera and geometry (BASELINE configs 2+3+4
    combined).
    """
    f = _hybrid_mesh_vjp_fn(
        width, height, spp,
        grad_spp if grad_spp is not None else spp,
        max_depth, inclusive_uv, spectral,
    )
    return f(scene, camera, jnp.int32(seed))


def render_hdr(scene, camera, width, height, **kw) -> jnp.ndarray:
    """Render to an (H, W, 3) top-down HDR image."""
    flat = render_flat_engine(scene, camera, width=width, height=height, **kw)
    return img_io.assemble_image(flat, width, height)


def render(
    scene,
    camera,
    width: int,
    height: int,
    *,
    samples_per_pixel: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    semantics: str = "physical",
    tonemap: str = "gamma",
    inclusive_uv: bool = True,
    spectral: bool = False,
    engine: str = "auto",
    shading: str = "full",
    output_path: str | None = None,
) -> np.ndarray:
    """Render, tone map, optionally save a PNG; returns (H, W, 3) uint8.

    Signature mirrors the reference package API
    (`/root/reference/src/spira-metal-optimized.jl:1453-1455`).
    ``shading="preview"``/``"normal"`` switch to the single-bounce
    quick-look renderers (reference §2.5 single-bounce family).
    """
    if shading != "full":
        from .integrator.preview import render_flat_preview

        flat = render_flat_preview(
            scene, camera, width=width, height=height, seed=seed,
            shading=shading, inclusive_uv=inclusive_uv,
        )
        hdr = img_io.assemble_image(flat, width, height)
    else:
        hdr = render_hdr(
            scene,
            camera,
            width,
            height,
            spp=samples_per_pixel,
            max_depth=max_depth,
            seed=seed,
            semantics=semantics,
            inclusive_uv=inclusive_uv,
            spectral=spectral,
            engine=engine,
        )
    ldr = img_io.TONEMAPS[tonemap](hdr)
    out = img_io.to_uint8(ldr)
    if output_path is not None:
        if output_path.endswith(".exr"):
            img_io.save_exr(output_path, np.asarray(hdr))
        elif output_path.endswith(".ppm"):
            img_io.save_ppm(output_path, out)
        else:
            img_io.save_png(output_path, out)
    return out


def render_hybrid_gpu(scene, camera, width, height, **kw):
    """Compatibility alias for the reference's accelerated entry point
    (`render_hybrid_gpu`, /root/reference/src/spira-metal-optimized.jl:1228):
    the engine-dispatched accelerated render (see :data:`ENGINE_TABLE`)."""
    return render(scene, camera, width, height, **kw)


def render_with_cpu(scene, camera, width, height, **kw):
    """Compatibility alias for the reference CPU fallback renderer
    (`render_with_cpu`, /root/reference/src/spira-metal-optimized.jl:1346):
    the wavefront engine in bug-compatible reference semantics."""
    kw.setdefault("semantics", "reference")
    kw.setdefault("engine", "wavefront")
    return render(scene, camera, width, height, **kw)
