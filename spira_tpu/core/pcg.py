"""PCG4D counter hash — the kernel-side RNG.

A pure-`jnp` uint32 implementation of the pcg4d hash (Jarzynski & Olano,
"Hash Functions for GPU Rendering", JCGT 2020 — published construction built
on the PCG family), usable identically inside Pallas kernels, under XLA, and
in Pallas interpret mode.

Counter-based like the threefry layer in :mod:`spira_tpu.core.rng` — every
draw is a pure function of (pixel, sample, bounce·stream, seed), so kernel
renders are replayable and backend-independent.  Used by the fused Pallas
megakernel; the XLA wavefront path keeps threefry.

The per-pixel LCG/xorshift state buffers of the reference
(`/root/reference/src/spira_path_trace_kernel.metal:52-58`,
`/root/reference/src/spira-metal-optimized.jl:412-426`) have no analogue
here: no state, no buffer, no hazard.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_MUL = np.uint32(1664525)
_INC = np.uint32(1013904223)


def pcg4d(a, b, c, d):
    """pcg4d hash: four uint32 counters → four decorrelated uint32s."""
    a = a.astype(jnp.uint32) * _MUL + _INC
    b = b.astype(jnp.uint32) * _MUL + _INC
    c = c.astype(jnp.uint32) * _MUL + _INC
    d = d.astype(jnp.uint32) * _MUL + _INC
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    return a, b, c, d


def to_uniform(bits):
    """uint32 → float32 in [0, 1) using the top 24 bits (exact in f32).

    Routed via int32 — safe since the shifted value fits in 24 bits, and
    the signed convert is the cheaper instruction.
    """
    return (bits >> np.uint32(8)).astype(jnp.int32).astype(jnp.float32) * np.float32(
        1.0 / (1 << 24)
    )


def uniform4(pixel, sample, stream, seed):
    """Four independent U[0,1) draws per lane.

    pixel: per-lane counter array (any uint-castable); sample/stream/seed:
    scalars or arrays broadcastable to it.
    """
    pixel = jnp.asarray(pixel)
    shape = pixel.shape
    a, b, c, d = pcg4d(
        pixel,
        jnp.broadcast_to(jnp.asarray(sample), shape),
        jnp.broadcast_to(jnp.asarray(stream), shape),
        jnp.broadcast_to(jnp.asarray(seed), shape),
    )
    return to_uniform(a), to_uniform(b), to_uniform(c), to_uniform(d)


def box_muller(u1, u2):
    """Two standard normals from two uniforms."""
    r = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u1, 1e-10)))
    theta = np.float32(2.0 * np.pi) * u2
    return r * jnp.cos(theta), r * jnp.sin(theta)
