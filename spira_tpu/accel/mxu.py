"""MXU-traversal BVH packing: superleaves as Plücker coefficient matrices.

A matrix-unit answer to per-thread GPU traversal (reference `hit_bvh`,
`/root/reference/examples/julia-raytracer-optimized.jl:1710-1830`): instead
of making 1024 rays chase pointers, collapse the binary BVH into a SHALLOW
16-wide tree whose leaves are *superleaves* of up to 128 triangles, and
intersect a whole superleaf against a whole ray packet with **matrix
multiplies on a matrix unit** (the packing of a retired experiment; its
kernel was removed, the NumPy oracle stays).

Möller–Trumbore in Plücker form is linear in per-ray features: with
``m = o × d`` and per-triangle constants ``n = e1×e2``, ``cu = v0×e2``,
``cv = v0×e1``, ``kt = v0·n``::

    det   = -n·d
    u_num =  e2·m + cu·d          u = u_num / det
    v_num = -e1·m - cv·d          v = v_num / det
    t_num =  n·o  - kt            t = t_num / det

so a couple of ``(tris, 8)·(8, 1024)`` MXU contractions evaluate det / u /
v / t for 128 triangles x 1024 rays — ~3 MMAC, zero per-lane gathers, zero
vector→scalar extracts (the two costs an earlier packet kernel's
measurements identified as its bottleneck).

Per superleaf (lane j = triangle j of the block), three row groups of 8:

* ``coeff_uv`` (8, 384): one fused [det | u_num | v_num] matrix against the
  ray features F_uv = [m(3), d(3), 0, 0] — lanes 0:128 det (rows 3:6 = -n),
  128:256 u_num (rows 0:3 = e2, 3:6 = cu), 256:384 v_num (-e1, -cv).
* ``coeff_t``  (8, 128): t_num against F_o1 = [o(3), 0, 0, 0, 1, 0]
  (rows 0:3 = n, row 6 = -kt).
* ``coeff_pay`` (8, 128): payload rows 0:3 = unit shading normal, material
  id — resolved per visit by one (8,128)x(128,1024) one-hot matmul.

Empty lanes are all-zero: det == 0 -> u/v/t become inf/NaN and every hit
condition fails, masking padding for free.  Cut nodes are BIN-PACKED into
shared blocks (first-fit decreasing): testing a co-resident node's
triangles is free and correct (they are real geometry), so fill stays
~100% and the tables cost a flat ~176 bytes/triangle of VMEM.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..core.types import pytree_dataclass
from .wide import SLOT, WIDTH, _collapse16

#: triangles per superleaf block (coefficient lane width)
SUPERLEAF = 128
#: rows per superleaf in each coefficient table
BLOCK_ROWS = 8


@pytree_dataclass(meta_fields=("root", "n_nodes", "n_leaves"))
class MXUBVH:
    """Device-resident shallow-wide BVH with Plücker superleaf matrices."""

    nodes: jnp.ndarray  # (N, 128) f32 wide-node rows (SMEM-resident)
    coeff_uv: jnp.ndarray  # (n_leaves * 8, 384) f32: [det | u_num | v_num]
    coeff_t: jnp.ndarray  # (n_leaves * 8, 128) f32: t_num
    coeff_pay: jnp.ndarray  # (n_leaves * 8, 128) f32: normal + material
    root: int = 0
    n_nodes: int = 0
    n_leaves: int = 0


def _leaf_blocks(v0, e1, e2, nrm, mat):
    """Per-superleaf (uv (8,384), t (8,128), pay (8,128)) coefficients."""
    k = v0.shape[0]
    uv = np.zeros((BLOCK_ROWS, 3 * SUPERLEAF), np.float32)
    tb = np.zeros((BLOCK_ROWS, SUPERLEAF), np.float32)
    pay = np.zeros((BLOCK_ROWS, SUPERLEAF), np.float32)
    n = np.cross(e1, e2)
    cu = np.cross(v0, e2)
    cv = np.cross(v0, e1)
    kt = np.sum(v0 * n, axis=1)
    uv[3:6, 0:k] = -n.T  # det: d part
    uv[0:3, 128 : 128 + k] = e2.T  # u_num: m part
    uv[3:6, 128 : 128 + k] = cu.T  # u_num: d part
    uv[0:3, 256 : 256 + k] = -e1.T  # v_num: m part
    uv[3:6, 256 : 256 + k] = -cv.T  # v_num: d part
    tb[0:3, :k] = n.T  # t_num: o part
    tb[6, :k] = -kt  # t_num: const part
    pay[0:3, :k] = nrm.T  # unit shading normal
    pay[3, :k] = mat  # material id
    return uv, tb, pay


def _cut_and_blocks(left, right, is_leaf, prim_idx, v0, e1, e2, nrm, mat,
                    kids, n_bin, superleaf):
    """Superleaf cut + block packing shared by the wide (streaming) and
    pair-tree packings: returns ``(is_cut, leaf_id, tricount, uv_blocks,
    t_blocks, pay_blocks)`` where ``leaf_id`` maps cut node -> block index.
    """
    # subtree triangle counts (iterative post-order)
    tricount = np.zeros(n_bin, np.int64)
    post = []
    stk = [0]
    while stk:
        i = stk.pop()
        post.append(i)
        if is_leaf[i] == 0:
            stk.extend(kids(i))
    for i in reversed(post):
        tricount[i] = (
            int(right[i]) if is_leaf[i] == 1
            else sum(tricount[c] for c in kids(i))
        )

    # cut set: highest nodes with <= superleaf triangles
    is_cut = np.zeros(n_bin, bool)
    stk = [0]
    cut_nodes = []
    while stk:
        i = stk.pop()
        if tricount[i] <= superleaf:
            is_cut[i] = True
            cut_nodes.append(i)
        else:
            stk.extend(kids(i))

    def subtree_prims(i: int):
        out, s = [], [i]
        while s:
            j = s.pop()
            if is_leaf[j] == 1:
                first, count = int(left[j]), int(right[j])
                out.extend(prim_idx[first : first + count].tolist())
            else:
                s.extend(kids(j))
        return out

    # Bin-pack cut nodes into shared 128-lane blocks (first-fit decreasing);
    # see module docstring for why co-residency is free.
    order = sorted(cut_nodes, key=lambda i: -int(tricount[i]))
    leaf_id = {}
    bins: list[list[int]] = []  # prim lists per block
    space: list[int] = []
    for i in order:
        prims = subtree_prims(i)
        k = next(
            (b for b in range(len(bins)) if space[b] >= len(prims)), None
        )
        if k is None:
            k = len(bins)
            bins.append([])
            space.append(SUPERLEAF)
        leaf_id[i] = k
        bins[k].extend(prims)
        space[k] -= len(prims)

    uv_blocks, t_blocks, pay_blocks = [], [], []
    for prim_list in bins:
        prims = np.asarray(prim_list, np.int64)
        uv, tb, pay = _leaf_blocks(
            v0[prims], e1[prims], e2[prims], nrm[prims], mat[prims]
        )
        uv_blocks.append(uv)
        t_blocks.append(tb)
        pay_blocks.append(pay)
    if not uv_blocks:
        uv, tb, pay = (
            np.zeros((BLOCK_ROWS, 3 * SUPERLEAF), np.float32),
            np.zeros((BLOCK_ROWS, SUPERLEAF), np.float32),
            np.zeros((BLOCK_ROWS, SUPERLEAF), np.float32),
        )
        uv_blocks, t_blocks, pay_blocks = [uv], [tb], [pay]
    return is_cut, leaf_id, tricount, uv_blocks, t_blocks, pay_blocks


def pack_bvh_mxu(bvh, tris, superleaf: int = SUPERLEAF) -> MXUBVH:
    """Collapse a binary FlatBVH + Triangles into wide nodes + superleaves.

    A binary node becomes a superleaf when its subtree holds ``<= superleaf``
    triangles (and its parent's doesn't); the internal structure above the
    cut is 16-wide packed exactly like :func:`spira_tpu.accel.wide.pack_bvh16`.
    Smaller ``superleaf`` values trade denser box pruning (finer cut boxes)
    for more block visits; blocks stay 128 lanes wide either way.
    """
    if not 1 <= superleaf <= SUPERLEAF:
        raise ValueError(f"superleaf must be in 1..{SUPERLEAF}")
    node_min = np.asarray(bvh.node_min, np.float32)
    node_max = np.asarray(bvh.node_max, np.float32)
    left = np.asarray(bvh.left, np.int64)
    right = np.asarray(bvh.right, np.int64)
    is_leaf = np.asarray(bvh.is_leaf, np.int64)
    prim_idx = np.asarray(bvh.prim_idx, np.int64)

    v0 = np.asarray(tris.v0, np.float32)
    e1 = np.asarray(tris.e1, np.float32)
    e2 = np.asarray(tris.e2, np.float32)
    nrm = np.asarray(tris.normal, np.float32)
    mat = np.asarray(tris.material, np.float32)

    def kids(i: int):
        l, r = int(left[i]), int(right[i])
        return [l] if l == r else [l, r]

    is_cut, leaf_id, tricount, uv_blocks, t_blocks, pay_blocks = (
        _cut_and_blocks(
            left, right, is_leaf, prim_idx, v0, e1, e2, nrm, mat,
            kids, node_min.shape[0], superleaf,
        )
    )

    nodes, n_nodes = _collapse16(
        node_min, node_max, kids, is_cut,
        leaf_ptr=lambda i: leaf_id[i],
        leaf_cnt=lambda i: int(tricount[i]),
        subtree_weight=tricount,
    )
    return MXUBVH(
        nodes=jnp.asarray(nodes),
        coeff_uv=jnp.asarray(np.concatenate(uv_blocks, axis=0)),
        coeff_t=jnp.asarray(np.concatenate(t_blocks, axis=0)),
        coeff_pay=jnp.asarray(np.concatenate(pay_blocks, axis=0)),
        root=0,
        n_nodes=n_nodes,
        n_leaves=len(uv_blocks),
    )


def attach_mxu(scene, superleaf: int = SUPERLEAF):
    """Pack ``scene.bvh`` into MXU superleaf tables on ``scene.wide``."""
    from ..core.types import replace

    if scene.bvh is None:
        raise ValueError("attach_mxu requires a scene with a built BVH")
    return replace(scene, wide=pack_bvh_mxu(scene.bvh, scene.triangles,
                                            superleaf))


def traverse_mxu_numpy(packed: MXUBVH, origin, direction, t_min=1e-3):
    """Scalar NumPy oracle evaluating the PACKED tables (tests only):
    nearest hit (t, normal, mat) for one ray, or (inf, 0, -1).

    Evaluates the same Plücker contraction the kernel runs, so coefficient
    packing bugs show up here."""
    nodes = np.asarray(packed.nodes)
    cuv = np.asarray(packed.coeff_uv, np.float64)
    ct = np.asarray(packed.coeff_t, np.float64)
    cpay = np.asarray(packed.coeff_pay, np.float64)
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    m = np.cross(o, d)
    f_uv = np.concatenate([m, d, [0.0, 0.0]])
    f_o1 = np.concatenate([o, [0.0, 0.0, 0.0], [1.0, 0.0]])
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(d) > 1e-12, 1.0 / d, 1e12)

    best = (np.inf, np.zeros(3), -1)
    stack = [packed.root]
    while stack:
        p = stack.pop()
        rec = nodes[p]
        for c in range(WIDTH):
            b = SLOT * c
            lo, hi = rec[b : b + 3], rec[b + 3 : b + 6]
            ptr, cnt = rec[b + 6], int(rec[b + 7])
            if c == 0:
                ptr = np.floor(ptr / 4.0)
            if cnt < 0:
                continue
            t0 = (lo - o) * inv
            t1 = (hi - o) * inv
            tn = max(np.minimum(t0, t1).max(), 0.0)
            tf = min(np.maximum(t0, t1).min(), best[0])
            if tn > tf:
                continue
            if cnt == 0:
                stack.append(int(ptr))
                continue
            base = int(ptr) * BLOCK_ROWS
            quv = cuv[base : base + 8].T @ f_uv  # (384,)
            det = quv[0:128]
            un = quv[128:256]
            vn = quv[256:384]
            tn_ = ct[base : base + 8].T @ f_o1
            ok = np.abs(det) > 1e-12
            idet = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
            u = un * idet
            v = vn * idet
            t = tn_ * idet
            hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
            t = np.where(hit, t, np.inf)
            j = int(np.argmin(t))
            if t[j] < best[0]:
                pay = cpay[base : base + 8, j]
                best = (float(t[j]), pay[0:3].copy(), int(pay[3]))
    return best


@pytree_dataclass(meta_fields=("root", "n_pairs", "n_blocks", "depth"))
class SuperleafBVH:
    """Pair-record tree over MXU superleaf blocks.

    The round-2 queued lever for mesh throughput: keep the packet kernel's
    pruned pair-record traversal (`accel/pairs.py` format — the slab tests,
    ordered descent and SMEM stack are unchanged) but make every leaf a
    128-triangle Plücker coefficient block intersected on the MXU instead
    of a 16-triangle VPU scalar-broadcast loop.  Fewer, fatter leaves mean
    a ~3-level shallower tree (fewer pops and vector→scalar readbacks) at
    the cost of coarser leaf-level pruning; `docs/ARCHITECTURE.md` records
    which side wins per mesh size.

    ``pairs`` rows follow `accel.pairs.PackedBVH.pairs` exactly, except a
    leaf child's ``ptr`` is a superleaf BLOCK index into the coefficient
    tables (rows ``ptr*8 : ptr*8+8``); ``count`` keeps the cut node's
    triangle count (the kernel only tests it ``> 0``, since a block visit
    always evaluates all 128 lanes — empty lanes have det == 0).
    """

    pairs: jnp.ndarray  # (P, 16) float32 pair records
    coeff_uv: jnp.ndarray  # (n_blocks * 8, 384) f32
    coeff_t: jnp.ndarray  # (n_blocks * 8, 128) f32
    coeff_pay: jnp.ndarray  # (n_blocks * 8, 128) f32
    root: int = 0
    n_pairs: int = 0
    n_blocks: int = 0
    depth: int = 1  # pair records on the longest root->leaf chain


def pack_bvh_superleaf(bvh, tris, superleaf: int = SUPERLEAF) -> SuperleafBVH:
    """Pack a FlatBVH + Triangles into pair records over superleaf blocks."""
    if not 1 <= superleaf <= SUPERLEAF:
        raise ValueError(f"superleaf must be in 1..{SUPERLEAF}")
    node_min = np.asarray(bvh.node_min, np.float32)
    node_max = np.asarray(bvh.node_max, np.float32)
    left = np.asarray(bvh.left, np.int64)
    right = np.asarray(bvh.right, np.int64)
    is_leaf = np.asarray(bvh.is_leaf, np.int64)
    prim_idx = np.asarray(bvh.prim_idx, np.int64)
    if is_leaf.size and int((np.asarray(right)[is_leaf == 1]).max(initial=0)) > superleaf:
        raise ValueError(
            "builder leaves exceed the superleaf size; rebuild the BVH with "
            f"leaf_size <= {superleaf}"
        )

    v0 = np.asarray(tris.v0, np.float32)
    e1 = np.asarray(tris.e1, np.float32)
    e2 = np.asarray(tris.e2, np.float32)
    nrm = np.asarray(tris.normal, np.float32)
    mat = np.asarray(tris.material, np.float32)

    def kids(i: int):
        l, r = int(left[i]), int(right[i])
        return [l] if l == r else [l, r]

    is_cut, leaf_id, tricount, uv_blocks, t_blocks, pay_blocks = (
        _cut_and_blocks(
            left, right, is_leaf, prim_idx, v0, e1, e2, nrm, mat,
            kids, node_min.shape[0], superleaf,
        )
    )

    # pair records over the contracted tree (internal nodes above the cut);
    # construction shared with accel.pairs (only the leaf payload differs:
    # superleaf BLOCK index instead of tri-row pointer)
    from .pairs import build_pair_records, pad8

    internal = []
    if not is_cut[0]:
        stk = [0]
        while stk:
            i = stk.pop()
            internal.append(i)
            stk.extend(c for c in kids(i) if not is_cut[c])

    pairs, root, depth = build_pair_records(
        0,
        internal,
        kids,
        lambda c: is_cut[c],
        lambda c: (leaf_id[c], int(tricount[c])),
        lambda c: (node_min[c], node_max[c]),
    )

    return SuperleafBVH(
        pairs=jnp.asarray(pad8(pairs)),
        coeff_uv=jnp.asarray(np.concatenate(uv_blocks, axis=0)),
        coeff_t=jnp.asarray(np.concatenate(t_blocks, axis=0)),
        coeff_pay=jnp.asarray(np.concatenate(pay_blocks, axis=0)),
        root=int(root),
        n_pairs=pairs.shape[0],
        n_blocks=len(uv_blocks),
        depth=depth,
    )


def attach_superleaf(scene, superleaf: int = SUPERLEAF):
    """Pack ``scene.bvh`` into pair-tree superleaf tables on ``scene.wide``
    (the slot the MXU-leaf packet engine reads)."""
    from ..core.types import replace

    if scene.bvh is None:
        raise ValueError("attach_superleaf requires a scene with a built BVH")
    return replace(
        scene,
        wide=pack_bvh_superleaf(scene.bvh, scene.triangles, superleaf),
    )


def traverse_superleaf_numpy(packed: SuperleafBVH, origin, direction,
                             t_min=1e-3):
    """Scalar NumPy oracle over the SuperleafBVH tables (tests only):
    nearest hit (t, normal, mat) for one ray, or (inf, 0, -1).  Runs the
    pair-record walk of `pairs.traverse_packed_numpy` with the Plücker
    block evaluation of `traverse_mxu_numpy`."""
    pairs = np.asarray(packed.pairs)
    cuv = np.asarray(packed.coeff_uv, np.float64)
    ct = np.asarray(packed.coeff_t, np.float64)
    cpay = np.asarray(packed.coeff_pay, np.float64)
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    m = np.cross(o, d)
    f_uv = np.concatenate([m, d, [0.0, 0.0]])
    f_o1 = np.concatenate([o, [0.0, 0.0, 0.0], [1.0, 0.0]])
    inv = np.where(np.abs(d) > 1e-12, 1.0 / d, 1e12)

    best = (np.inf, np.zeros(3), -1)
    stack = [packed.root]
    while stack:
        p = stack.pop()
        rec = pairs[p]
        for half in (0, 1):
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
            base = ptr * BLOCK_ROWS
            quv = cuv[base : base + 8].T @ f_uv
            det = quv[0:128]
            un = quv[128:256]
            vn = quv[256:384]
            tn_ = ct[base : base + 8].T @ f_o1
            ok = np.abs(det) > 1e-12
            idet = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
            u = un * idet
            v = vn * idet
            t = np.where(ok, tn_ * idet, np.inf)
            hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
            t = np.where(hit, t, np.inf)
            j = int(np.argmin(t))
            if t[j] < best[0]:
                pay = cpay[base : base + 8, j]
                best = (float(t[j]), pay[0:3].copy(), int(pay[3]))
    return best
