"""Vectorized ray–primitive intersection over whole wavefronts.

Reference counterparts: the `hit(...)` multiple-dispatch family
(`/root/reference/examples/julia-raytracer-optimized.jl:318-497`), the
per-sphere broadcast stage of the wavefront renderer
(`/root/reference/src/spira-metal-optimized.jl:700-799`) and the MSL
`intersect_sphere` (`/root/reference/src/spira_path_trace_kernel.metal:109-136`).

An intersection test is an elementwise op over an (N_rays, N_prims) grid.
The wavefront stays resident; the nearest-hit reduction is a masked min
over the primitive axis.  No per-ray scalar loops,
no `allowscalar` update loop (the reference's known perf sin, SURVEY.md §2.2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from ..core.types import pytree_dataclass
from ..core.vecmath import INF, T_MIN

_HIGHEST = jax.lax.Precision.HIGHEST


@pytree_dataclass
class Hit:
    """Per-ray nearest-hit record (all (N,) / (N,3))."""

    t: jnp.ndarray
    normal: jnp.ndarray  # geometric unit normal (outward, not face-forwarded)
    material: jnp.ndarray  # int32 material index (0 where no hit)
    hit: jnp.ndarray  # bool


def no_hit(n: int) -> Hit:
    return Hit(
        t=jnp.full((n,), INF, jnp.float32),
        normal=jnp.zeros((n, 3), jnp.float32),
        material=jnp.zeros((n,), jnp.int32),
        hit=jnp.zeros((n,), bool),
    )


def intersect_spheres(spheres, origins, directions, t_min=T_MIN, t_max=INF) -> Hit:
    """Nearest sphere hit per ray; brute force over all spheres.

    Quadratic in half-b form, both roots, exactly the reference math
    (`/root/reference/src/spira-metal-optimized.jl:1363-1383`): assumes unit
    directions (a == 1).
    """
    n = origins.shape[0]
    if spheres.count == 0:
        return no_hit(n)

    oc = origins[:, None, :] - spheres.centers[None, :, :]  # (N,S,3)
    half_b = jnp.einsum("nsc,nc->ns", oc, directions, precision=_HIGHEST)
    c = jnp.sum(oc * oc, axis=-1) - spheres.radii[None, :] ** 2
    disc = half_b * half_b - c
    # double-where guards: sqrt'(0)=inf and 1/0 in masked-off branches would
    # otherwise poison reverse-mode (camera/geometry gradients).
    disc_ok = disc > 0.0
    sqrtd = jnp.where(disc_ok, jnp.sqrt(jnp.where(disc_ok, disc, 1.0)), 0.0)
    root0 = -half_b - sqrtd
    root1 = -half_b + sqrtd
    root = jnp.where(root0 > t_min, root0, root1)
    valid = disc_ok & (root > t_min) & (root < t_max)
    t = jnp.where(valid, root, INF)

    t_best = jnp.min(t, axis=1)  # (N,)
    hit = t_best < INF
    # One-hot winner selection (first match on ties) as a float32 product
    # at full precision, which selects rows exactly and keeps gradients
    # deterministic (a gather's transpose would scatter with atomics).
    is_best = (t == t_best[:, None]) & valid
    one_hot = (is_best & (jnp.cumsum(is_best, axis=1) == 1)).astype(
        jnp.float32
    )
    # INF stays in Hit.t (merge_hits relies on it); use a guarded t for the
    # normal computation only.
    t_safe = jnp.where(hit, t_best, 1.0)

    center = jnp.matmul(one_hot, spheres.centers, precision=_HIGHEST)  # (N,3)
    p = origins + t_safe[:, None] * directions
    normal = vm.normalize(p - center)
    material = jnp.matmul(
        one_hot, spheres.material.astype(jnp.float32), precision=_HIGHEST
    ).astype(jnp.int32)
    return Hit(t=t_best, normal=normal, material=material, hit=hit)


def intersect_triangles(
    tris, origins, directions, t_min=T_MIN, t_max=INF
) -> Hit:
    """Nearest triangle hit per ray; vectorized Möller–Trumbore.

    Brute force over all T triangles — (N, T) intermediate; use the BVH path
    for large meshes.  Reference scalar form:
    `/root/reference/examples/julia-raytracer-optimized.jl:350-397`.
    """
    n = origins.shape[0]
    if tris.count == 0:
        return no_hit(n)

    t, u, v, det = _moller_trumbore(tris, origins, directions)
    valid = (
        (jnp.abs(det) > 1e-9)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    t = jnp.where(valid, t, INF)
    t_best = jnp.min(t, axis=1)
    hit = t_best < INF
    is_best = (t == t_best[:, None]) & valid
    one_hot = (is_best & (jnp.cumsum(is_best, axis=1) == 1)).astype(
        jnp.float32
    )
    normal = jnp.matmul(one_hot, tris.normal, precision=_HIGHEST)
    material = jnp.matmul(
        one_hot, tris.material.astype(jnp.float32), precision=_HIGHEST
    ).astype(jnp.int32)
    return Hit(t=t_best, normal=normal, material=material, hit=hit)


def _moller_trumbore(tris, origins, directions):
    """Raw Möller–Trumbore terms over (N rays, T tris): t, u, v, det."""
    d = directions[:, None, :]  # (N,1,3)
    e1 = tris.e1[None, :, :]  # (1,T,3)
    e2 = tris.e2[None, :, :]
    pvec = jnp.cross(d, e2)  # (N,T,3)
    det = jnp.sum(e1 * pvec, axis=-1)  # (N,T)
    det_ok = jnp.abs(det) > 1e-12
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    tvec = origins[:, None, :] - tris.v0[None, :, :]
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    return t, u, v, det


def merge_hits(a: Hit, b: Hit) -> Hit:
    """Nearest of two hit records."""
    take_b = b.t < a.t
    return Hit(
        t=jnp.where(take_b, b.t, a.t),
        normal=vm.where(take_b, b.normal, a.normal),
        material=jnp.where(take_b, b.material, a.material),
        hit=a.hit | b.hit,
    )


def intersect_scene(scene, origins, directions, t_min=T_MIN) -> Hit:
    """Nearest hit against everything in the scene.

    A mixed sphere+triangle tree (``bvh.n_sph > 0``, see
    :func:`spira_tpu.accel.bvh.build_mixed_bvh`) resolves everything in one
    traversal.  Otherwise spheres are brute force (small count) and
    triangles go through the flat-BVH traversal when ``scene.bvh`` is set,
    else brute force.
    """
    if scene.bvh is not None and scene.bvh.n_sph > 0:
        from ..accel.traverse import intersect_bvh_mixed

        return intersect_bvh_mixed(
            scene.bvh, scene.spheres, scene.triangles, origins, directions,
            t_min,
        )
    hit = intersect_spheres(scene.spheres, origins, directions, t_min)
    if scene.bvh is not None:
        from ..accel.traverse import intersect_bvh

        tri_hit = intersect_bvh(scene.bvh, scene.triangles, origins, directions, t_min)
        hit = merge_hits(hit, tri_hit)
    elif scene.triangles.count > 0:
        tri_hit = intersect_triangles(scene.triangles, origins, directions, t_min)
        hit = merge_hits(hit, tri_hit)
    return hit
