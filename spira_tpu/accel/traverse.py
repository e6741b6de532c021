"""Vectorized BVH traversal over a ray wavefront (pure XLA).

Two implementations of the reference's GPU traversal (`hit_bvh`,
`/root/reference/examples/julia-raytracer-optimized.jl:1710-1775`):

* :func:`intersect_bvh` — **stackless** state-machine traversal (Hapala et
  al. 2011 style: parent/sibling links, ENTER/LEAVE states).  The production
  path: the per-iteration footprint is exactly two packed node-table
  gathers and the leaf gathers — and **zero scatters** (no per-ray stack
  array to update).
* :func:`intersect_bvh_stack` — the literal stack-per-ray form (64-deep,
  push right then left), kept as the structural mirror of the MSL kernel and
  as a differential-testing oracle for the stackless version.

Both run a device-side `lax.while_loop` until every ray finishes (no host
sync); dead lanes are masked.  The reference's own broken variant (left
child never pushed, `/root/reference/examples/spira-metal-raytracer.jl:606`)
is the cautionary tale: tests compare both traversals against brute force
exhaustively.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from ..core.vecmath import INF, T_MIN
from ..integrator.intersect import Hit
from .bvh import MAX_STACK


def _slab_test(node_min, node_max, origins, inv_dir, t_max):
    """Branchless AABB slab test (the precomputed-inverse form of
    `/root/reference/examples/spira-metal-raytracer.jl:151-175`).
    All args (N,3)/(N,); returns (N,) bool."""
    t0 = (node_min - origins) * inv_dir
    t1 = (node_max - origins) * inv_dir
    tsmall = jnp.minimum(t0, t1)
    tbig = jnp.maximum(t0, t1)
    tmin = jnp.maximum(jnp.max(tsmall, axis=-1), 0.0)
    tmax = jnp.minimum(jnp.min(tbig, axis=-1), t_max)
    return tmin <= tmax


def _safe_inv(directions):
    return jnp.where(
        jnp.abs(directions) > 1e-12, 1.0 / directions, jnp.float32(1e12)
    )


def _winner_triangle_hit(tris, best_prim, found, origins, directions) -> Hit:
    """Differentiable hit record against an already-selected triangle.

    Traversal loops only SELECT the winning primitive (a discrete choice a
    `lax.while_loop` cannot reverse-differentiate); t/normal are recomputed
    here with one gather + Möller–Trumbore so camera/geometry gradients
    flow (same hit-record math as the reference,
    /root/reference/examples/julia-raytracer-optimized.jl:350-397).
    """
    v0 = tris.v0[best_prim]
    e1 = tris.e1[best_prim]
    e2 = tris.e2[best_prim]
    pvec = jnp.cross(directions, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    det_ok = jnp.abs(det) > 1e-9
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    tvec = origins - v0
    qvec = jnp.cross(tvec, e1)
    tt = jnp.sum(e2 * qvec, axis=-1) * inv_det
    return Hit(
        t=jnp.where(found, tt, INF),
        normal=tris.normal[best_prim],
        material=tris.material[best_prim],
        hit=found,
    )


def intersect_bvh(bvh, tris, origins, directions, t_min=T_MIN) -> Hit:
    """Stackless nearest-hit traversal (production path)."""
    # gradients: the while_loop runs on stopped inputs; the returned hit is
    # differentiably recomputed against the winner (_winner_triangle_hit)
    best_t, best_prim = bvh_winner(bvh, tris, origins, directions, t_min)
    return _winner_triangle_hit(
        tris, best_prim, best_t < INF, origins, directions
    )


def bvh_winner(bvh, tris, origins, directions, t_min=T_MIN):
    """The stackless walk itself: ``(best_t, best_prim)`` per ray, the
    nearest hit distance (INF on a miss) and the winning triangle's index.
    Not differentiable; :func:`intersect_bvh` adds the hit record."""
    origins = jax.lax.stop_gradient(origins)
    directions = jax.lax.stop_gradient(directions)
    tris_ng = jax.lax.stop_gradient(tris)

    leaf_size = bvh.max_leaf
    n_prims = tris.count
    inv_dir = _safe_inv(directions)

    # Packed tables: one float gather + one int gather per node visit
    # (loop-invariant; XLA hoists the packing out of the while loop).
    nodes_f = jax.lax.stop_gradient(
        jnp.concatenate([bvh.node_min, bvh.node_max], axis=1)
    )  # (M,6)
    nodes_i = jnp.stack(
        [bvh.left, bvh.right, bvh.is_leaf, bvh.parent, bvh.sibling,
         bvh.is_left],
        axis=1,
    )  # (M,6)
    tris9 = jnp.concatenate(
        [tris_ng.v0, tris_ng.e1, tris_ng.e2], axis=1
    )  # (T,9)

    zero_i = (origins[:, 0] * 0).astype(jnp.int32)
    state = (
        zero_i,  # cur node (root)
        zero_i < 1,  # entering (all True)
        zero_i > 0,  # done (all False)
        origins[:, 0] * 0 + INF,  # best_t
        zero_i,  # best_prim
        jnp.sum(zero_i),  # iteration counter (varying-typed scalar)
    )
    # The while condition is a reduction over every ray, so CHUNK traversal
    # steps run per check; leaf primitives are gathered as per-slot rows.
    chunk = 8
    max_iters = 4 * bvh.node_count + 64  # safety bound

    def cond(s):
        _, _, done, _, _, it = s
        return jnp.any(~done) & (it < max_iters)

    def step(s):
        cur, entering, done, best_t, best_prim, it = s

        nf = nodes_f[cur]  # (N,6)
        ni = nodes_i[cur]  # (N,6)
        left = ni[:, 0]
        right = ni[:, 1]
        is_leaf = ni[:, 2] == 1
        parent = ni[:, 3]
        sibling = ni[:, 4]
        is_left = ni[:, 5] == 1

        active = entering & ~done
        box_hit = _slab_test(nf[:, 0:3], nf[:, 3:6], origins, inv_dir, best_t)
        box_hit = box_hit & active

        # ---- leaf: per-slot 1-D row gathers
        leaf_proc = box_hit & is_leaf
        for j in range(leaf_size):
            prim_valid = leaf_proc & (j < right)  # right = leaf count
            slot = jnp.clip(left + j, 0, max(n_prims - 1, 0))
            prim = bvh.prim_idx[slot]  # (N,)
            td = tris9[prim]  # (N,9)
            v0 = td[:, 0:3]
            e1 = td[:, 3:6]
            e2 = td[:, 6:9]
            pvec = jnp.cross(directions, e2)
            det = jnp.sum(e1 * pvec, axis=-1)
            det_ok = jnp.abs(det) > 1e-9
            inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
            tvec = origins - v0
            uu = jnp.sum(tvec * pvec, axis=-1) * inv_det
            qvec = jnp.cross(tvec, e1)
            vv = jnp.sum(directions * qvec, axis=-1) * inv_det
            tt = jnp.sum(e2 * qvec, axis=-1) * inv_det
            closer = (
                prim_valid
                & det_ok
                & (uu >= 0.0)
                & (vv >= 0.0)
                & (uu + vv <= 1.0)
                & (tt > t_min)
                & (tt < best_t)
            )
            best_t = jnp.where(closer, tt, best_t)
            best_prim = jnp.where(closer, prim, best_prim)

        # ---- transitions (Hapala state machine)
        descend = box_hit & ~is_leaf
        has_sib = is_left & (sibling >= 0)
        up_next = jnp.where(has_sib, sibling, parent)
        finish = ~descend & ~done
        new_done = done | (finish & (cur == 0))
        next_cur = jnp.where(descend, left, up_next)
        next_cur = jnp.where(new_done, cur * 0, jnp.maximum(next_cur, 0))
        next_entering = descend | (~descend & has_sib)

        return (next_cur, next_entering, new_done, best_t, best_prim, it + 1)

    def body(s):
        for _ in range(chunk):
            s = step(s)
        return s

    _, _, _, best_t, best_prim, _ = jax.lax.while_loop(cond, body, state)
    return best_t, best_prim


def intersect_bvh_mixed(
    bvh, spheres, tris, origins, directions, t_min=T_MIN
) -> Hit:
    """Stackless traversal over a mixed sphere+triangle tree
    (:func:`spira_tpu.accel.bvh.build_mixed_bvh`); the wavefront form of the
    reference's typed-primitive leaf loop (`hit_bvh` dispatching
    sphere/triangle intersects,
    /root/reference/examples/julia-raytracer-optimized.jl:1710-1775).

    Each leaf slot gathers one sphere row and one triangle row and selects
    the test by primitive type — both are 1-D row gathers (the fast case in
    the measured cost model); the extra masked test per slot beats a
    per-ray brute-force pass over every sphere once spheres are plentiful.
    """
    # gradients: discrete traversal on stopped inputs, winner recomputed
    # differentiably after the loop (see _winner_triangle_hit)
    o_diff, d_diff = origins, directions
    origins = jax.lax.stop_gradient(origins)
    directions = jax.lax.stop_gradient(directions)
    tris_ng = jax.lax.stop_gradient(tris) if tris is not None else None
    spheres_ng = jax.lax.stop_gradient(spheres)

    leaf_size = bvh.max_leaf
    n_sph = bvh.n_sph
    n_tris = tris.count if tris is not None else 0
    n_total = n_sph + n_tris
    inv_dir = _safe_inv(directions)

    nodes_f = jax.lax.stop_gradient(
        jnp.concatenate([bvh.node_min, bvh.node_max], axis=1)
    )
    nodes_i = jnp.stack(
        [bvh.left, bvh.right, bvh.is_leaf, bvh.parent, bvh.sibling,
         bvh.is_left],
        axis=1,
    )
    sph4 = jnp.concatenate(
        [spheres_ng.centers, spheres_ng.radii[:, None]], axis=1
    )  # (S,4)
    if n_tris > 0:
        tris9 = jnp.concatenate(
            [tris_ng.v0, tris_ng.e1, tris_ng.e2], axis=1
        )

    zero_i = (origins[:, 0] * 0).astype(jnp.int32)
    state = (
        zero_i,
        zero_i < 1,
        zero_i > 0,
        origins[:, 0] * 0 + INF,
        zero_i,
        jnp.sum(zero_i),
    )
    chunk = 8
    max_iters = 4 * bvh.node_count + 64

    def cond(s):
        _, _, done, _, _, it = s
        return jnp.any(~done) & (it < max_iters)

    def step(s):
        cur, entering, done, best_t, best_prim, it = s
        nf = nodes_f[cur]
        ni = nodes_i[cur]
        left = ni[:, 0]
        right = ni[:, 1]
        is_leaf = ni[:, 2] == 1
        parent = ni[:, 3]
        sibling = ni[:, 4]
        is_left = ni[:, 5] == 1

        active = entering & ~done
        box_hit = _slab_test(nf[:, 0:3], nf[:, 3:6], origins, inv_dir, best_t)
        box_hit = box_hit & active

        leaf_proc = box_hit & is_leaf
        for j in range(leaf_size):
            prim_valid = leaf_proc & (j < right)
            slot = jnp.clip(left + j, 0, n_total - 1)
            prim = bvh.prim_idx[slot]  # (N,) typed id
            is_s = prim < n_sph
            # ---- sphere test (half-b quadratic)
            sp = jnp.clip(prim, 0, max(n_sph - 1, 0))
            sd = sph4[sp]  # (N,4)
            oc = origins - sd[:, 0:3]
            half_b = jnp.sum(oc * directions, axis=-1)
            c = jnp.sum(oc * oc, axis=-1) - sd[:, 3] * sd[:, 3]
            disc = half_b * half_b - c
            disc_ok = disc > 0.0
            sqrtd = jnp.sqrt(jnp.where(disc_ok, disc, 0.0))
            root0 = -half_b - sqrtd
            root1 = -half_b + sqrtd
            t_s = jnp.where(root0 > t_min, root0, root1)
            valid_s = disc_ok & (t_s > t_min)
            if n_tris > 0:
                # ---- triangle test (Möller–Trumbore)
                tp = jnp.clip(prim - n_sph, 0, n_tris - 1)
                td = tris9[tp]
                v0 = td[:, 0:3]
                e1 = td[:, 3:6]
                e2 = td[:, 6:9]
                pvec = jnp.cross(directions, e2)
                det = jnp.sum(e1 * pvec, axis=-1)
                det_ok = jnp.abs(det) > 1e-9
                inv_det = jnp.where(
                    det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0
                )
                tvec = origins - v0
                uu = jnp.sum(tvec * pvec, axis=-1) * inv_det
                qvec = jnp.cross(tvec, e1)
                vv = jnp.sum(directions * qvec, axis=-1) * inv_det
                t_t = jnp.sum(e2 * qvec, axis=-1) * inv_det
                valid_t = (
                    det_ok
                    & (uu >= 0.0)
                    & (vv >= 0.0)
                    & (uu + vv <= 1.0)
                    & (t_t > t_min)
                )
                tt = jnp.where(is_s, t_s, t_t)
                valid = jnp.where(is_s, valid_s, valid_t)
            else:
                tt = t_s
                valid = valid_s
            closer = prim_valid & valid & (tt < best_t)
            best_t = jnp.where(closer, tt, best_t)
            best_prim = jnp.where(closer, prim, best_prim)

        descend = box_hit & ~is_leaf
        has_sib = is_left & (sibling >= 0)
        up_next = jnp.where(has_sib, sibling, parent)
        finish = ~descend & ~done
        new_done = done | (finish & (cur == 0))
        next_cur = jnp.where(descend, left, up_next)
        next_cur = jnp.where(new_done, cur * 0, jnp.maximum(next_cur, 0))
        next_entering = descend | (~descend & has_sib)
        return (next_cur, next_entering, new_done, best_t, best_prim, it + 1)

    def body(s):
        for _ in range(chunk):
            s = step(s)
        return s

    _, _, _, best_t, best_prim, _ = jax.lax.while_loop(cond, body, state)

    # ---- differentiable winner recompute (camera/geometry gradients)
    hit = best_t < INF
    is_s = best_prim < n_sph
    sp = jnp.clip(best_prim, 0, max(n_sph - 1, 0))
    center = spheres.centers[sp]
    oc = o_diff - center
    half_b = jnp.sum(oc * d_diff, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - spheres.radii[sp] ** 2
    disc = half_b * half_b - c
    # sqrt at 0 has an infinite derivative; guard the unselected lanes so
    # the masked-out branch cannot poison gradients with 0*inf = NaN
    sqrtd = jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0))
    root0 = -half_b - sqrtd
    root1 = -half_b + sqrtd
    t_s = jnp.where(root0 > t_min, root0, root1)
    t_safe = jnp.where(hit & is_s, t_s, 1.0)
    p = o_diff + t_safe[:, None] * d_diff
    sph_n = vm.normalize(p - center)
    if n_tris > 0:
        tp = jnp.clip(best_prim - n_sph, 0, n_tris - 1)
        tri = _winner_triangle_hit(tris, tp, hit & ~is_s, o_diff, d_diff)
        t_out = jnp.where(is_s, jnp.where(hit, t_s, INF), tri.t)
        normal = jnp.where(is_s[:, None], sph_n, tri.normal)
        material = jnp.where(is_s, spheres.material[sp], tri.material)
    else:
        t_out = jnp.where(hit, t_s, INF)
        normal = sph_n
        material = spheres.material[sp]
    return Hit(t=t_out, normal=normal, material=material, hit=hit)


def intersect_bvh_stack(bvh, tris, origins, directions, t_min=T_MIN) -> Hit:
    """Stack-per-ray traversal (the MSL kernel's literal shape); testing
    oracle for :func:`intersect_bvh`.

    Wavefront state: per-ray stack (N, MAX_STACK+1) — the last column is a
    write-discard slot for masked pushes — stack pointer, and running
    nearest-hit registers.
    """
    o_diff, d_diff = origins, directions
    origins = jax.lax.stop_gradient(origins)
    directions = jax.lax.stop_gradient(directions)
    tris_ng = jax.lax.stop_gradient(tris)

    n = origins.shape[0]
    leaf_size = bvh.max_leaf
    rows = jnp.arange(n)
    inv_dir = _safe_inv(directions)

    zero_i = (origins[:, 0] * 0).astype(jnp.int32)
    stack = jnp.zeros((n, MAX_STACK + 1), jnp.int32) + zero_i[:, None]
    ptr = zero_i + 1  # root (node 0) pre-pushed at slot 0
    best_t = origins[:, 0] * 0 + INF
    best_prim = zero_i

    def cond(state):
        _, ptr, _, _ = state
        return jnp.any(ptr > 0)

    def body(state):
        stack, ptr, best_t, best_prim = state
        active = ptr > 0
        top = jnp.maximum(ptr - 1, 0)
        node = stack[rows, top]
        ptr = jnp.where(active, ptr - 1, ptr)

        nmin = jax.lax.stop_gradient(bvh.node_min[node])
        nmax = jax.lax.stop_gradient(bvh.node_max[node])
        box_hit = _slab_test(nmin, nmax, origins, inv_dir, best_t)
        process = active & box_hit

        node_is_leaf = bvh.is_leaf[node] == 1
        leaf = process & node_is_leaf
        first = bvh.left[node]
        count = bvh.right[node]
        n_prims = tris.count
        for j in range(leaf_size):
            prim_valid = leaf & (j < count)
            slot = jnp.clip(first + j, 0, n_prims - 1)
            prim = bvh.prim_idx[slot]
            v0 = tris_ng.v0[prim]
            e1 = tris_ng.e1[prim]
            e2 = tris_ng.e2[prim]
            pvec = jnp.cross(directions, e2)
            det = vm.dot(e1, pvec)
            det_ok = jnp.abs(det) > 1e-9
            inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
            tvec = origins - v0
            uu = vm.dot(tvec, pvec) * inv_det
            qvec = jnp.cross(tvec, e1)
            vv = vm.dot(directions, qvec) * inv_det
            tt = vm.dot(e2, qvec) * inv_det
            valid = (
                det_ok
                & (uu >= 0.0)
                & (vv >= 0.0)
                & (uu + vv <= 1.0)
                & (tt > t_min)
                & (tt < best_t)
            )
            closer = prim_valid & valid
            best_t = jnp.where(closer, tt, best_t)
            best_prim = jnp.where(closer, prim, best_prim)

        # Internal: push right then left (left popped first, like the MSL
        # traversal).  A redirect node (left == right, from the two-level
        # stitcher) pushes only once.
        internal = process & ~node_is_leaf
        left = bvh.left[node]
        right = bvh.right[node]
        push_right = internal & (left != right)

        # Masked pushes route to the write-discard column MAX_STACK.
        idx = jnp.where(push_right, ptr, MAX_STACK)
        stack = stack.at[rows, idx].set(right)
        ptr = ptr + push_right.astype(jnp.int32)

        idx = jnp.where(internal, ptr, MAX_STACK)
        stack = stack.at[rows, idx].set(left)
        ptr = ptr + internal.astype(jnp.int32)

        return stack, ptr, best_t, best_prim

    _, _, best_t, best_prim = jax.lax.while_loop(
        cond, body, (stack, ptr, best_t, best_prim)
    )

    return _winner_triangle_hit(
        tris, best_prim, best_t < INF, o_diff, d_diff
    )
