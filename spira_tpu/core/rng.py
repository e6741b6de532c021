"""Counter-based sampling (threefry) for the path tracer.

Replaces the reference's three stateful RNGs (SURVEY.md §2.6):

* LCG with a per-pixel state buffer
  (`/root/reference/src/spira_path_trace_kernel.metal:52-58`),
* xorshift32 with host-seeded state buffers
  (`/root/reference/src/spira-metal-optimized.jl:412-426`),
* Julia global ``rand()`` on the CPU paths.

This design is stateless and counter-based: every random draw is a
pure function of ``(seed, sample_index, bounce_index, stream)`` plus the ray's
position in the wavefront array.  One threefry call produces randomness for
the *entire* wavefront at once (fully vectorized), and any draw can be
replayed exactly — which is what makes the path-replay backward pass possible
without storing a tape.

Streams (a draw site inside one bounce) are enumerated in :class:`Stream`.
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp

from . import vecmath as vm


class Stream(enum.IntEnum):
    """Draw sites within one bounce (the 'stream' axis of the counter)."""

    PIXEL_JITTER = 0  # 2 uniforms for sub-pixel uv jitter
    LOBE_SELECT = 1  # metallic-vs-diffuse branch (MSL kernel :225)
    DIFFUSE_DIR = 2  # diffuse scatter direction
    METAL_FUZZ = 3  # roughness perturbation of the mirror direction
    ROULETTE = 4  # Russian-roulette continuation draw (MSL kernel :246-253)
    WAVELENGTH = 5  # hero-wavelength selection (spectral renderer)
    LENS = 6  # aperture / depth-of-field disk sample


def base_key(seed) -> jax.Array:
    """Root key for a render; everything else is folded in from here."""
    return jax.random.key(jnp.asarray(seed, jnp.uint32))


def sample_key(key: jax.Array, sample_idx) -> jax.Array:
    return jax.random.fold_in(key, sample_idx)


def bounce_key(skey: jax.Array, bounce_idx, stream: Stream) -> jax.Array:
    return jax.random.fold_in(jax.random.fold_in(skey, bounce_idx), int(stream))


def uniform(key, shape=(), dtype=jnp.float32):
    return jax.random.uniform(key, shape, dtype)


def uniform_box3(key, shape, dtype=jnp.float32):
    """Uniform in [0,1)^3 — matches Julia ``rand(Vec3)`` used by the CPU
    reference scatter (`/root/reference/src/spira-metal-optimized.jl:1399,1404`)."""
    return jax.random.uniform(key, shape + (3,), dtype)


def unit_vector(key, shape, dtype=jnp.float32):
    """Uniform direction on the unit sphere.

    The reference uses unbounded rejection sampling
    (`/root/reference/src/spira_path_trace_kernel.metal:61-70`); that is a
    data-dependent loop XLA cannot vectorize, so we use the closed-form
    Gaussian-normalize construction (the reference itself ships the Box–Muller
    equivalent at
    `/root/reference/examples/julia-raytracer-optimized-metal.jl:833-848`).
    Changes the sample sequence, not the distribution — image comparisons are
    statistical (SURVEY.md §7 hard parts).
    """
    g = jax.random.normal(key, shape + (3,), dtype)
    return vm.normalize(g)


def cosine_hemisphere(key, normal, dtype=jnp.float32):
    """Cosine-weighted hemisphere direction about unit ``normal``.

    Disk-project construction mirroring
    /root/reference/src/spira_path_trace_kernel.metal:73-93.
    ``normal``: (..., 3); returns (..., 3).
    """
    shape = normal.shape[:-1]
    r = jax.random.uniform(key, shape + (2,), dtype)
    phi = 2.0 * jnp.pi * r[..., 0]
    sq = jnp.sqrt(r[..., 1])
    x = jnp.cos(phi) * sq
    y = jnp.sin(phi) * sq
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - x * x - y * y))
    u, v = vm.orthonormal_basis(normal)
    return vm.normalize(
        x[..., None] * u + y[..., None] * v + z[..., None] * normal
    )
