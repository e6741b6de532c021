"""Batched 3-vector math on ``(..., 3)`` arrays.

The reference duplicates a scalar Vec3 layer per file (SVector{3,Float32} at
`/root/reference/src/spira-metal-optimized.jl:282-290`, hand-rolled structs at
`/root/reference/examples/julia-raytracer.jl:11-41`).  Here every vector op
runs over a whole wavefront of rays at once, so the canonical layout is an
array with a trailing length-3 axis and an arbitrary batch prefix.  All
helpers here broadcast.
"""

from __future__ import annotations

import jax.numpy as jnp

# Constants mirroring /root/reference/src/spira-metal-optimized.jl:287-290.
INF = jnp.float32(1e20)
EPS = jnp.float32(1e-6)
# Scatter-origin offset used by the MSL megakernel
# (/root/reference/src/spira_path_trace_kernel.metal:7, EPSILON = 1e-4).
SCATTER_EPS = jnp.float32(1e-4)
# Minimum-t for intersections in the CPU reference
# (/root/reference/src/spira-metal-optimized.jl:1374: root < 0.001).
T_MIN = jnp.float32(1e-3)


def vec3(x, y, z, dtype=jnp.float32):
    return jnp.stack(
        [jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)], axis=-1
    )


def dot(a, b):
    """Batched dot product over the trailing axis, keepdims=False."""
    return jnp.sum(a * b, axis=-1)


def vdot(a, b):
    """Batched dot product, keeping the trailing axis for broadcasting."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def length_sq(a):
    return jnp.sum(a * a, axis=-1)


def length(a):
    return jnp.sqrt(length_sq(a))


def normalize(a, eps=1e-20):
    """Safe normalize: returns a / |a| with a tiny floor to avoid 0/0."""
    return a * jnp.reciprocal(jnp.maximum(length(a), eps))[..., None]


def cross(a, b):
    return jnp.cross(a, b)


def reflect(incident, normal):
    """Mirror reflection (direction convention of
    /root/reference/src/spira_path_trace_kernel.metal:97-99)."""
    return incident - 2.0 * vdot(incident, normal) * normal


def refract(incident, normal, eta):
    """Snell refraction of a unit ``incident`` about unit ``normal``.

    ``eta`` = n_incident / n_transmitted.  Returns (refracted_dir,
    total_internal_reflection_mask).  Callers select reflect() where TIR.
    """
    cos_i = -vdot(incident, normal)
    sin2_t = (eta**2) * jnp.maximum(0.0, 1.0 - cos_i**2)
    tir = sin2_t[..., 0] > 1.0
    # double-where: sqrt'(0)=inf at grazing/TIR would poison reverse-mode
    ok = sin2_t < 1.0
    cos_t = jnp.where(ok, jnp.sqrt(jnp.where(ok, 1.0 - sin2_t, 1.0)), 0.0)
    refracted = eta * incident + (eta * cos_i - cos_t) * normal
    return refracted, tir


def orthonormal_basis(w):
    """Build (u, v) completing unit vector ``w`` to a right-handed frame.

    Branchless form of the MSL helper at
    /root/reference/src/spira_path_trace_kernel.metal:87-91 (pick the axis
    least aligned with w, then two cross products).
    """
    pick_y = jnp.abs(w[..., 0:1]) > 0.1
    helper = jnp.where(
        pick_y,
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], w.dtype), w.shape),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], w.dtype), w.shape),
    )
    u = normalize(jnp.cross(helper, w))
    v = jnp.cross(w, u)
    return u, v


def where(mask, a, b):
    """Select over vectors with a scalar-per-ray mask of shape batch."""
    return jnp.where(mask[..., None], a, b)
