"""Pair-record BVH packing for a packet-traversal kernel (host-side NumPy).

The kernel these tables fed was written for a vector machine without fast
per-lane gathers or per-lane scatter for traversal stacks, and was removed
with that machine; the packing and its NumPy oracle remain.  The packet
kernel shared ONE
traversal among all 1024 rays of an (8, 128) tile: scalar control flow +
an SMEM stack drive the tree walk, while every box/triangle test is a
full-tile VPU op.  That flips the reference's thread-per-ray stack traversal
(`hit_bvh`, /root/reference/examples/julia-raytracer-optimized.jl:1710-1775)
into classic packet tracing (Wald et al. 2001) — the shape that fits a
128-lane vector unit.

Memory layout is chosen so the kernel's ONLY dynamic access is a
row load at a dynamic *sublane* index (the supported-fast Mosaic case):

* ``pairs`` (P, 16) float32 — one row per *internal* FlatBVH node, holding
  BOTH children: ``[min3 | max3 | ptr | count] x 2``.  A child entry is
  self-describing: ``count == 0`` -> internal, ``ptr`` = pair row of that
  child; ``count > 0`` -> leaf, ``ptr`` = row into ``tri_rows``;
  ``count < 0`` -> empty slot (box is inverted so the slab test never hits).
  ptr/count are stored as exact small floats (no bitcasting needed
  in-kernel).
* ``tri_rows`` (R, 128) float32 — 8 triangles per row, 16 lanes each.
  Two forms (``PackedBVH.form``), same slot/`prim_map` addressing:

  - ``"mt"`` — Möller–Trumbore operands:
    ``[v0(3) e1(3) e2(3) n(3) mat(1) pad(3)]``;
  - ``"bw"`` — Baldwin–Weber world→barycentric transform (Baldwin &
    Weber, JCGT 2016: precompute the affine maps u(p), v(p) and the
    plane equation, turning the per-ray test into two dots, one divide
    and two affine evaluations — ~25% fewer VPU ops than MT at the
    same 13 broadcast constants):
    ``[n̂(3) n̂·v0(1) A(3) a3(1) B(3) b3(1) mat(1) pad(3)]`` where
    ``u(p) = A·p + a3``, ``v(p) = B·p + b3``,
    ``A = (e2 × n)/|n|², B = (n × e1)/|n|²`` (n = e1 × e2 unnormalized).

  Every leaf owns whole rows, so leaf intersection is one (1, 128)
  vector load + static lane extracts.

The packing is host-side NumPy, one-time per scene (like the flat-BVH
serialization of the reference, `serialize_scene_for_gpu`
/root/reference/examples/julia-raytracer-optimized.jl:1242-1324).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..core.types import pytree_dataclass

TRIS_PER_ROW = 8
TRI_STRIDE = 16  # lanes per triangle within a packed row
PAIR_WIDTH = 16

# Child-entry field offsets within a pair record half.
_MIN = 0
_MAX = 3
_PTR = 6
_CNT = 7


@pytree_dataclass(
    meta_fields=("root", "n_rows", "n_pairs", "max_leaf", "depth", "form",
                 "fanout")
)
class PackedBVH:
    """Device-resident pair-record BVH (replicated per chip)."""

    pairs: jnp.ndarray  # (P, 8*fanout) float32
    tri_rows: jnp.ndarray  # (R, 128) float32
    # slot -> original triangle index (slot = row*8 + lane/16); -1 padding.
    # Lets the differentiable intersect hook gather the winning triangle's
    # exact data for the gradient-carrying hit recompute.
    prim_map: jnp.ndarray = None  # (R*8,) int32
    root: int = 0  # pair row of the root record (static)
    n_rows: int = 0
    n_pairs: int = 0
    max_leaf: int = TRIS_PER_ROW
    depth: int = 1  # pair records on the longest root->leaf chain
    form: str = "mt"  # leaf operand layout: "mt" | "bw" (module docstring)
    # children per record: 2 (pair records) or 4 (quad records — the
    # BVH2→BVH4 collapse: each record holds grandchildren of a binary
    # internal node, halving pop batches and stack traffic; round 5)
    fanout: int = 2


def _leaf_rows_needed(count: int) -> int:
    return (count + TRIS_PER_ROW - 1) // TRIS_PER_ROW


def build_pair_records(root_node, internal, kids, is_leaf_node, leaf_entry,
                       box):
    """Shared pair-record construction for every packing that feeds the
    packet traversal (`pack_bvh` leaf rows, `accel.mxu.pack_bvh_superleaf`
    MXU blocks — only the leaf payload pointer differs).

    * ``internal``: node ids that get a pair row, in row order.
    * ``kids(i)``: the 1 or 2 children of internal node ``i`` (1 = the
      two-level builder's redirect node; the second slot becomes empty).
    * ``is_leaf_node(c)`` / ``leaf_entry(c) -> (ptr, count)``: what makes a
      child a leaf and where its payload lives.
    * ``box(c) -> (min3, max3)``.

    Returns ``(pairs, root_row, depth)`` with ``depth`` the longest
    root->leaf chain in pair records (the kernel validates its SMEM stack
    against it).  A leaf root is wrapped in a pseudo pair record.
    """
    pair_of = {int(i): k for k, i in enumerate(internal)}
    root_is_leaf = bool(is_leaf_node(root_node))
    total_pairs = max(len(internal) + (1 if root_is_leaf else 0), 1)
    pairs = np.zeros((total_pairs, PAIR_WIDTH), np.float32)

    def entry(c):
        lo3, hi3 = box(c)
        if is_leaf_node(c):
            ptr, cnt = leaf_entry(c)
            return lo3, hi3, ptr, cnt
        return lo3, hi3, pair_of[int(c)], 0

    # Empty child slot: cnt == -1 gates it out in the kernel and the oracle;
    # the box is a harmless point at the origin (inf/NaN-free arithmetic).
    empty = (np.zeros(3, np.float32), np.zeros(3, np.float32), 0, -1)

    def fill(rec, half, ent):
        lo3, hi3, ptr, cnt = ent
        base = 8 * half
        rec[base + _MIN : base + _MIN + 3] = lo3
        rec[base + _MAX : base + _MAX + 3] = hi3
        rec[base + _PTR] = float(ptr)
        rec[base + _CNT] = float(cnt)

    for i in internal:
        rec = pairs[pair_of[int(i)]]
        ks = kids(i)
        fill(rec, 0, entry(ks[0]))
        fill(rec, 1, entry(ks[1]) if len(ks) == 2 else empty)

    if root_is_leaf:
        # degenerate tree: wrap the single leaf in a pseudo pair record
        root = len(internal)
        fill(pairs[root], 0, entry(root_node))
        fill(pairs[root], 1, empty)
    else:
        root = pair_of[int(root_node)]

    # longest root->leaf chain through pair records; a two-level tree can
    # stack a top tree above per-mesh trees, so the builders' per-tree
    # depth cap does not bound the packed depth by itself
    depth = 1
    chain = [(int(root), 1)]
    while chain:
        rec, d = chain.pop()
        depth = max(depth, d)
        for half in (0, 1):
            if pairs[rec, 8 * half + _CNT] == 0.0:  # internal child
                chain.append((int(pairs[rec, 8 * half + _PTR]), d + 1))

    return pairs, int(root), depth


def build_quad_records(root_node, kids, is_leaf_node, leaf_entry, box):
    """BVH2→BVH4 collapse: one 32-lane record per *representative* binary
    internal node, holding its grandchildren (or leaf children) —
    ``[min3 | max3 | ptr | count] x 4``.  Internal entries point to the
    quad row of that binary node; empty slots have count == -1.  Halves
    the popped-record count and the stack traffic of the packet traversal
    at identical leaf work (the children tested per pop are the same
    boxes, one tree level earlier).

    Returns (quads (Q, 32), root_row, depth).
    """
    empty = (np.zeros(3, np.float32), np.zeros(3, np.float32), 0, -1)

    row_of = {}
    order = []

    def want_row(i):
        i = int(i)
        if i not in row_of:
            row_of[i] = len(order)
            order.append(i)
        return row_of[i]

    if is_leaf_node(root_node):
        # degenerate tree: one pseudo record holding the single leaf
        lo3, hi3 = box(root_node)
        ptr, cnt = leaf_entry(root_node)
        quads = np.zeros((1, 32), np.float32)
        ents = [(lo3, hi3, ptr, cnt)] + [empty] * 3
        for half, (lo, hi, p, c) in enumerate(ents):
            b = 8 * half
            quads[0, b : b + 3] = lo
            quads[0, b + 3 : b + 6] = hi
            quads[0, b + 6] = float(p)
            quads[0, b + 7] = float(c)
        return quads, 0, 1

    want_row(root_node)
    rows = []
    k = 0
    while k < len(order):
        i = order[k]
        k += 1
        ents = []
        for c in kids(i):
            if is_leaf_node(c):
                lo3, hi3 = box(c)
                ptr, cnt = leaf_entry(c)
                ents.append((lo3, hi3, ptr, cnt))
                continue
            for gc in kids(c):
                lo3, hi3 = box(gc)
                if is_leaf_node(gc):
                    ptr, cnt = leaf_entry(gc)
                    ents.append((lo3, hi3, ptr, cnt))
                else:
                    ents.append((lo3, hi3, want_row(gc), 0))
        while len(ents) < 4:
            ents.append(empty)
        rows.append(ents)

    quads = np.zeros((len(rows), 32), np.float32)
    for r, ents in enumerate(rows):
        for half, (lo3, hi3, ptr, cnt) in enumerate(ents):
            b = 8 * half
            quads[r, b : b + 3] = lo3
            quads[r, b + 3 : b + 6] = hi3
            quads[r, b + 6] = float(ptr)
            quads[r, b + 7] = float(cnt)

    # longest root->leaf chain in quad records
    depth = 1
    chain = [(0, 1)]
    while chain:
        rec, d = chain.pop()
        depth = max(depth, d)
        for half in range(4):
            if quads[rec, 8 * half + 7] == 0.0:
                chain.append((int(quads[rec, 8 * half + 6]), d + 1))
    return quads, 0, depth


def pad8(a: np.ndarray) -> np.ndarray:
    """Pad the sublane (leading) dim to a multiple of 8."""
    p = (-a.shape[0]) % 8
    if p:
        a = np.concatenate([a, np.zeros((p,) + a.shape[1:], a.dtype)])
    return a


def _bw_operands(v0, e1, e2, nrm):
    """Baldwin–Weber precompute for (T, 3) triangle arrays: returns the
    12 per-triangle leaf constants ``[n̂(3), n̂·v0, A(3), a3, B(3), b3]``.

    ``u(p) = A·p + a3`` and ``v(p) = B·p + b3`` are the barycentric
    coordinates of any point p ON the triangle's plane;
    ``t = (n̂·v0 − n̂·o) / (n̂·d)`` is the plane hit.  Degenerate (zero-area)
    triangles get A = B = 0, a3 = b3 = −1, so u < 0 always rejects.
    """
    n = np.cross(e1, e2)
    n2 = (n * n).sum(axis=1, keepdims=True)
    safe = np.where(n2 > 0.0, n2, 1.0)
    A = np.cross(e2, n) / safe
    B = np.cross(n, e1) / safe
    a3 = -(v0 * A).sum(axis=1, keepdims=True)
    b3 = -(v0 * B).sum(axis=1, keepdims=True)
    degen = n2 <= 0.0
    A = np.where(degen, 0.0, A)
    B = np.where(degen, 0.0, B)
    a3 = np.where(degen, -1.0, a3)
    b3 = np.where(degen, -1.0, b3)
    dn = (nrm * v0).sum(axis=1, keepdims=True)
    return np.concatenate([nrm, dn, A, a3, B, b3], axis=1).astype(np.float32)


def pack_bvh(bvh, tris, materials=None, form="bw", fanout=2) -> PackedBVH:
    """Convert a FlatBVH + Triangles into pair records + packed tri rows.

    Leaves larger than ``TRIS_PER_ROW`` span multiple consecutive rows (the
    kernel unrolls ``ceil(max_leaf / 8)`` row loads).  ``form`` picks the
    leaf operand layout (module docstring): ``"bw"`` (default) or
    ``"mt"``.  ``fanout=4`` emits quad records
    (BVH2→BVH4 collapse, :func:`build_quad_records`).
    """
    node_min = np.asarray(bvh.node_min, np.float32)
    node_max = np.asarray(bvh.node_max, np.float32)
    left = np.asarray(bvh.left, np.int64)
    right = np.asarray(bvh.right, np.int64)
    is_leaf = np.asarray(bvh.is_leaf, np.int64)
    prim_idx = np.asarray(bvh.prim_idx, np.int64)

    if form not in ("mt", "bw"):
        raise ValueError(f"unknown leaf form {form!r} (expected 'mt'|'bw')")
    v0 = np.asarray(tris.v0, np.float32)
    e1 = np.asarray(tris.e1, np.float32)
    e2 = np.asarray(tris.e2, np.float32)
    nrm = np.asarray(tris.normal, np.float32)
    mat = np.asarray(tris.material, np.float32)
    bw = _bw_operands(v0, e1, e2, nrm) if form == "bw" else None

    internal = np.nonzero(is_leaf == 0)[0]

    # --- pack leaf triangle rows (one pass to size, one to fill)
    leaves = np.nonzero(is_leaf == 1)[0]
    total_rows = int(sum(_leaf_rows_needed(int(right[i])) for i in leaves))
    total_rows = max(total_rows, 1)
    tri_rows = np.zeros((total_rows, TRIS_PER_ROW * TRI_STRIDE), np.float32)
    prim_map = np.full(total_rows * TRIS_PER_ROW, -1, np.int32)
    leaf_row = {}
    row = 0
    for i in leaves:
        first, count = int(left[i]), int(right[i])
        leaf_row[int(i)] = row
        prims = prim_idx[first : first + count]
        prim_map[row * TRIS_PER_ROW : row * TRIS_PER_ROW + count] = prims
        tri16 = np.zeros((count, TRI_STRIDE), np.float32)
        if form == "bw":
            tri16[:, 0:12] = bw[prims]
        else:
            tri16[:, 0:3] = v0[prims]
            tri16[:, 3:6] = e1[prims]
            tri16[:, 6:9] = e2[prims]
            tri16[:, 9:12] = nrm[prims]
        tri16[:, 12] = mat[prims]
        need = _leaf_rows_needed(count)
        flat = np.zeros((need, TRIS_PER_ROW * TRI_STRIDE), np.float32)
        flat.reshape(need * TRIS_PER_ROW, TRI_STRIDE)[:count] = tri16
        tri_rows[row : row + need] = flat
        row += need

    def kids(i):
        l, r = int(left[i]), int(right[i])
        return [l] if l == r else [l, r]  # l == r: two-level redirect node

    if fanout == 4:
        pairs, root, depth = build_quad_records(
            0,
            kids,
            lambda c: is_leaf[c] == 1,
            lambda c: (leaf_row[int(c)], int(right[c])),
            lambda c: (node_min[c], node_max[c]),
        )
    elif fanout == 2:
        pairs, root, depth = build_pair_records(
            0,
            internal,
            kids,
            lambda c: is_leaf[c] == 1,
            lambda c: (leaf_row[int(c)], int(right[c])),
            lambda c: (node_min[c], node_max[c]),
        )
    else:
        raise ValueError(f"fanout must be 2 or 4, got {fanout}")
    max_leaf = int(right[leaves].max()) if leaves.size else 1

    padded_rows = pad8(tri_rows)
    # The differentiable intersect hook tracks the winning slot as a
    # float32 (exact only below 2^24): fail loudly here instead of letting
    # >2M-triangle meshes silently gather wrong prim_map entries.
    if padded_rows.shape[0] * TRIS_PER_ROW >= 2 ** 24:
        raise ValueError(
            f"packed BVH has {padded_rows.shape[0] * TRIS_PER_ROW} tri "
            "slots; the float32 winner-slot register is exact only below "
            "2^24 — split the mesh or raise TRIS_PER_ROW"
        )
    if padded_rows.shape[0] > total_rows:
        prim_map = np.concatenate([
            prim_map,
            np.full((padded_rows.shape[0] - total_rows) * TRIS_PER_ROW, -1,
                    np.int32),
        ])
    return PackedBVH(
        pairs=jnp.asarray(pad8(pairs)),
        tri_rows=jnp.asarray(padded_rows),
        prim_map=jnp.asarray(prim_map),
        root=root,
        n_rows=total_rows,
        n_pairs=pairs.shape[0],
        max_leaf=max_leaf,
        depth=depth,
        form=form,
        fanout=fanout,
    )


def attach_packed(scene, form="bw", fanout=2):
    """Pack ``scene.bvh`` + triangles into pair tables and return a scene
    whose ``packed`` field feeds the Pallas packet megakernel."""
    from ..core.types import replace

    if scene.bvh is None:
        raise ValueError("attach_packed requires a scene with a built BVH")
    return replace(scene, packed=pack_bvh(scene.bvh, scene.triangles,
                                          form=form, fanout=fanout))


def traverse_packed_numpy(packed: PackedBVH, origin, direction, t_min=1e-3):
    """Scalar NumPy oracle over the packed tables (tests only): nearest hit
    (t, normal, mat) for one ray, or (inf, 0, -1)."""
    pairs = np.asarray(packed.pairs)
    rows = np.asarray(packed.tri_rows)
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    inv = np.where(np.abs(d) > 1e-12, 1.0 / d, 1e12)

    best = (np.inf, np.zeros(3), -1)
    fanout = getattr(packed, "fanout", 2)
    stack = [packed.root]
    while stack:
        p = stack.pop()
        rec = pairs[p]
        for half in range(fanout):
            b = 8 * half
            lo, hi = rec[b : b + 3], rec[b + 3 : b + 6]
            ptr, cnt = int(rec[b + 6]), int(rec[b + 7])
            t0 = (lo - o) * inv
            t1 = (hi - o) * inv
            tn = np.maximum(np.minimum(t0, t1).max(), 0.0)
            tf = np.minimum(np.maximum(t0, t1).min(), best[0])
            if tn > tf or cnt < 0:
                continue
            if cnt == 0:
                stack.append(ptr)
                continue
            for j in range(cnt):
                r, lane = ptr + j // TRIS_PER_ROW, TRI_STRIDE * (j % TRIS_PER_ROW)
                f = rows[r, lane : lane + TRI_STRIDE]
                if packed.form == "bw":
                    n, dn = f[0:3], f[3]
                    den = n @ d
                    if den == 0.0:
                        continue
                    t = (dn - n @ o) / den
                    p = o + t * d
                    u = f[4:7] @ p + f[7]
                    v = f[8:11] @ p + f[11]
                    nrm = n
                else:
                    v0, e1, e2 = f[0:3], f[3:6], f[6:9]
                    pv = np.cross(d, e2)
                    det = e1 @ pv
                    if abs(det) < 1e-9:
                        continue
                    tv = o - v0
                    u = (tv @ pv) / det
                    qv = np.cross(tv, e1)
                    v = (d @ qv) / det
                    t = (e2 @ qv) / det
                    nrm = f[9:12]
                if u >= 0 and v >= 0 and u + v <= 1 and t_min < t < best[0]:
                    best = (t, nrm.copy(), int(f[12]))
    return best
