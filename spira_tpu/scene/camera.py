"""Pinhole / thin-lens camera as a differentiable pytree.

Behavioral reference: `Camera` at
`/root/reference/src/spira-metal-optimized.jl:325-348` (lookfrom/lookat/vup/
vfov/aspect → origin, lower_left_corner, horizontal, vertical) and the
aperture/focus_dist variant at
`/root/reference/examples/julia-raytracer.jl:261-295`.

The derived frame is stored as arrays so camera gradients flow (BASELINE.json:
"pixel gradients w.r.t. ... camera").  UV convention matches the CPU
reference: v runs bottom-up; images are flipped at assembly
(`/root/reference/src/spira-metal-optimized.jl:1443`, ``img[height-j+1, i]``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core import rng as srng
from ..core import vecmath as vm
from ..core.types import pytree_dataclass


@pytree_dataclass(meta_fields=("has_lens",))
class Camera:
    origin: jnp.ndarray  # (3,)
    lower_left_corner: jnp.ndarray  # (3,)
    horizontal: jnp.ndarray  # (3,)
    vertical: jnp.ndarray  # (3,)
    u: jnp.ndarray  # (3,) right axis (for lens sampling)
    v: jnp.ndarray  # (3,) up axis
    lens_radius: jnp.ndarray  # () aperture/2; 0 = pinhole
    # Static dispatch flag: the tracers must not read the traced
    # lens_radius to pick their raygen (a host<->device sync per render
    # call).  Set once at construction from the concrete aperture.
    has_lens: bool = False


def make_camera(
    lookfrom,
    lookat,
    vup=(0.0, 1.0, 0.0),
    vfov=60.0,
    aspect_ratio=16.0 / 9.0,
    aperture=0.0,
    focus_dist=None,
) -> Camera:
    f32 = jnp.float32
    lookfrom = jnp.asarray(lookfrom, f32)
    lookat = jnp.asarray(lookat, f32)
    vup = jnp.asarray(vup, f32)

    theta = jnp.deg2rad(jnp.asarray(vfov, f32))
    h = jnp.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = jnp.asarray(aspect_ratio, f32) * viewport_height

    w = vm.normalize(lookfrom - lookat)
    u = vm.normalize(jnp.cross(vup, w))
    v = jnp.cross(w, u)

    if focus_dist is None:
        focus = jnp.asarray(1.0, f32)
    else:
        focus = jnp.asarray(focus_dist, f32)

    horizontal = focus * viewport_width * u
    vertical = focus * viewport_height * v
    llc = lookfrom - horizontal / 2.0 - vertical / 2.0 - focus * w
    return Camera(
        origin=lookfrom,
        lower_left_corner=llc,
        horizontal=horizontal,
        vertical=vertical,
        u=u,
        v=v,
        lens_radius=jnp.asarray(aperture, f32) / 2.0,
        has_lens=bool(np.asarray(aperture) > 0.0),
    )


def default_camera(aspect_ratio) -> Camera:
    """The demo camera of the reference `main()`
    (`/root/reference/src/spira-metal-optimized.jl:1499-1505`):
    lookfrom (0,1,3), lookat origin, vfov 60."""
    return make_camera(
        lookfrom=(0.0, 1.0, 3.0),
        lookat=(0.0, 0.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        vfov=60.0,
        aspect_ratio=aspect_ratio,
    )


def generate_rays(camera: Camera, width: int, height: int, key, *,
                  inclusive_uv: bool = True, row_start: int = 0,
                  n_rows: int | None = None, rows=None, blocks=None,
                  block_w: int = 128):
    """Jittered primary rays for a row-range of pixels, flattened to a
    (n_rows*W,) wavefront.

    Returns (origins (N,3), directions (N,3)).  Ray index
    ``r = (row - row_start) * W + col`` where ``row`` counts from the *bottom*
    of the image (reference v convention);
    :func:`spira_tpu.io.image.assemble_image` flips.  ``row_start``/``n_rows``
    select the tile a device owns under pixel-sharded rendering (the caller is
    responsible for folding the tile id into ``key`` so shards decorrelate).

    ``inclusive_uv=True`` divides by (dim-1) exactly like the CPU reference
    (`/root/reference/src/spira-metal-optimized.jl:1428-1429`); the MSL kernel
    divides by dim (`/root/reference/src/spira_path_trace_kernel.metal:160`).

    ``rows`` (an (R,) int32 array, may be traced) selects an arbitrary row
    SET instead of a contiguous range — the adaptive sampler dispatches only
    its unconverged rows this way.  Ray ``r = i * W + col`` covers
    ``rows[i]``; the caller owns key freshness across dispatches.

    ``blocks`` (a (B,) int32 array, may be traced) selects an arbitrary set
    of ``block_w``-pixel row SEGMENTS instead (block id = row * (W //
    block_w) + col_block; requires W % block_w == 0) — the finer adaptive
    granularity where segments, not whole rows, retire independently.
    Ray ``r = i * block_w + lane`` covers lane ``lane`` of ``blocks[i]``.
    """
    if blocks is not None:
        if width % block_w:
            raise ValueError(
                f"block-set raygen needs width % {block_w} == 0, got {width}"
            )
        nbx = width // block_w
        n_blocks = int(blocks.shape[0])
        n = n_blocks * block_w
        jit_key = srng.bounce_key(key, 0, srng.Stream.PIXEL_JITTER)
        jitter = srng.uniform(jit_key, (n, 2))
        idx = jnp.arange(n, dtype=jnp.int32)
        b = blocks[idx // block_w]
        col = ((b % nbx) * block_w + idx % block_w).astype(jnp.float32)
        row = (b // nbx).astype(jnp.float32)
        return _rays_from_uv(camera, width, height, key, jitter, col, row,
                             inclusive_uv, n)
    if rows is not None:
        n_rows = int(rows.shape[0])
        n = width * n_rows
        jit_key = srng.bounce_key(key, 0, srng.Stream.PIXEL_JITTER)
        jitter = srng.uniform(jit_key, (n, 2))
        idx = jnp.arange(n, dtype=jnp.int32)
        col = (idx % width).astype(jnp.float32)
        row = rows[idx // width].astype(jnp.float32)
        return _rays_from_uv(camera, width, height, key, jitter, col, row,
                             inclusive_uv, n)
    if n_rows is None:
        n_rows = height
    n = width * n_rows
    jit_key = srng.bounce_key(key, 0, srng.Stream.PIXEL_JITTER)
    jitter = srng.uniform(jit_key, (n, 2))

    idx = jnp.arange(n, dtype=jnp.int32)
    col = (idx % width).astype(jnp.float32)
    row = (idx // width + row_start).astype(jnp.float32)
    return _rays_from_uv(camera, width, height, key, jitter, col, row,
                         inclusive_uv, n)


def _rays_from_uv(camera, width, height, key, jitter, col, row,
                  inclusive_uv, n):

    du = jnp.float32(width - 1 if inclusive_uv else width)
    dv = jnp.float32(height - 1 if inclusive_uv else height)
    u = (col + jitter[:, 0]) / du
    v = (row + jitter[:, 1]) / dv

    target = (
        camera.lower_left_corner[None, :]
        + u[:, None] * camera.horizontal[None, :]
        + v[:, None] * camera.vertical[None, :]
    )

    lens_key = srng.bounce_key(key, 0, srng.Stream.LENS)
    disk = srng.uniform(lens_key, (n, 2))
    # Concentric-free polar disk sample (sufficient for DoF blur).
    r = jnp.sqrt(disk[:, 0])
    phi = 2.0 * jnp.pi * disk[:, 1]
    lens_offset = (camera.lens_radius * r)[:, None] * (
        jnp.cos(phi)[:, None] * camera.u[None, :]
        + jnp.sin(phi)[:, None] * camera.v[None, :]
    )

    origins = camera.origin[None, :] + lens_offset
    directions = vm.normalize(target - origins)
    return origins, directions
