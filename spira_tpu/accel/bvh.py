"""Flat BVH construction (host-side) for wavefront traversal on the device.

Design is the deduplicated union of the reference's three builders
(SURVEY.md §2.4): largest-centroid-extent axis, median split, leaf ≤ 4
primitives, flat node array + leaf-contiguous primitive permutation —
the shape of `build_flat_bvh_recursive!`
(`/root/reference/examples/julia-raytracer-optimized.jl:1327-1419`) and
`build_and_flatten_bvh_cpu` (`/root/reference/examples/spira-metal-raytracer.jl:346-487`),
re-expressed as NumPy SoA output that uploads directly as a pytree.

Layout (node i):
  * internal: ``left[i]``/``right[i]`` are child node indices,
    ``is_leaf[i] == 0``.
  * leaf: ``left[i]`` is the first index into ``prim_idx``, ``right[i]`` the
    primitive count, ``is_leaf[i] == 1``.

`build_two_level` stitches independently built per-mesh trees under a top
tree (the reference's scene-BVH-over-mesh-BVHs structure, `Mesh` ctor
`/root/reference/examples/julia-raytracer-optimized.jl:274-303`) into one
flat array so traversal stays a single kernel.

The builder is pure NumPy (host): BVH build is a one-time scene-preprocess
step; an optimized C++ builder with the same output contract lives in
``native/`` for large meshes.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..core.types import pytree_dataclass

LEAF_SIZE = 4  # reference leaf ≤4 (BVH v1/v2, SURVEY.md §2.4)
MAX_STACK = 64  # traversal stack depth, mirrors `uint stack[64]`
# (/root/reference/examples/julia-raytracer-optimized.jl:1722)


@pytree_dataclass(meta_fields=("max_leaf", "n_sph"))
class FlatBVH:
    """Device-resident flat BVH (replicated per chip under sharding)."""

    node_min: jnp.ndarray  # (M, 3)
    node_max: jnp.ndarray  # (M, 3)
    left: jnp.ndarray  # (M,) int32 — child index | first-prim offset
    right: jnp.ndarray  # (M,) int32 — child index | prim count
    is_leaf: jnp.ndarray  # (M,) int32 0/1
    prim_idx: jnp.ndarray  # (T,) int32 permutation into the triangle SoA
    # Stackless-traversal links (filled by add_links): parent node (-1 at
    # the root), sibling (-1 = none, e.g. under a two-level redirect), and
    # whether this node is its parent's left child.
    parent: jnp.ndarray = None  # (M,) int32
    sibling: jnp.ndarray = None  # (M,) int32
    is_left: jnp.ndarray = None  # (M,) int32 0/1
    max_leaf: int = LEAF_SIZE  # static: largest leaf count (unroll bound)
    # Mixed sphere+triangle trees (build_mixed_bvh): prim ids < n_sph are
    # sphere indices, ids >= n_sph index triangle (id - n_sph).  The typed
    # indirection of the reference flat BVH v1's GPUPrimitiveReference
    # (/root/reference/examples/julia-raytracer-optimized.jl:1232-1324),
    # encoded as an index offset instead of a (type, index) struct pair.
    n_sph: int = 0

    @property
    def node_count(self) -> int:
        return self.node_min.shape[0]


@dataclasses.dataclass
class _BuildArrays:
    node_min: list
    node_max: list
    left: list
    right: list
    is_leaf: list


def add_links(bvh: FlatBVH) -> FlatBVH:
    """Compute parent/sibling/is_left arrays for stackless traversal."""
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    is_leaf = np.asarray(bvh.is_leaf)
    m = left.shape[0]
    parent = np.full(m, -1, np.int32)
    sibling = np.full(m, -1, np.int32)
    is_left_arr = np.zeros(m, np.int32)
    internal = np.nonzero(is_leaf == 0)[0].astype(np.int32)
    l, r = left[internal], right[internal]
    parent[l] = internal
    is_left_arr[l] = 1
    # redirect nodes (two-level stitch) have a single child (l == r) whose
    # sibling stays -1
    two = internal[l != r]
    parent[right[two]] = two
    sibling[left[two]] = right[two]
    sibling[right[two]] = left[two]

    return dataclasses.replace(
        bvh,
        parent=jnp.asarray(parent),
        sibling=jnp.asarray(sibling),
        is_left=jnp.asarray(is_left_arr),
    )


def build_bvh(
    lo: np.ndarray, hi: np.ndarray, leaf_size: int = LEAF_SIZE
) -> FlatBVH:
    """Build a flat BVH over primitives with AABBs [lo, hi], both (T, 3)."""
    arrays, order = _build_arrays(lo, hi, leaf_size)
    leaf = np.asarray(arrays.is_leaf) == 1
    max_leaf = int(np.asarray(arrays.right)[leaf].max())
    return add_links(FlatBVH(
        node_min=jnp.asarray(np.asarray(arrays.node_min, np.float32)),
        node_max=jnp.asarray(np.asarray(arrays.node_max, np.float32)),
        left=jnp.asarray(np.asarray(arrays.left, np.int32)),
        right=jnp.asarray(np.asarray(arrays.right, np.int32)),
        is_leaf=jnp.asarray(np.asarray(arrays.is_leaf, np.int32)),
        prim_idx=jnp.asarray(order.astype(np.int32)),
        max_leaf=max_leaf,
    ))


def _build_arrays(lo, hi, leaf_size):
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    n = lo.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    centroids = 0.5 * (lo + hi)
    order = np.arange(n)

    arrays = _BuildArrays([], [], [], [], [])

    def alloc():
        i = len(arrays.left)
        arrays.node_min.append(np.zeros(3))
        arrays.node_max.append(np.zeros(3))
        arrays.left.append(0)
        arrays.right.append(0)
        arrays.is_leaf.append(0)
        return i

    # Iterative build (explicit stack): (node_index, start, end, depth).
    root = alloc()
    stack = [(root, 0, n, 0)]
    while stack:
        node, start, end, depth = stack.pop()
        idxs = order[start:end]
        arrays.node_min[node] = lo[idxs].min(axis=0)
        arrays.node_max[node] = hi[idxs].max(axis=0)
        count = end - start
        # Force a leaf at count ≤ leaf_size, or when too deep for the
        # traversal stack (MAX_STACK); mirrors the degenerate-split →
        # forced-leaf guard of BVH v2
        # (/root/reference/examples/spira-metal-raytracer.jl:384-487).
        if count <= leaf_size or depth >= MAX_STACK - 2:
            arrays.left[node] = start
            arrays.right[node] = count
            arrays.is_leaf[node] = 1
            continue
        # Largest-centroid-extent axis, median split.
        c = centroids[idxs]
        extent = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(extent))
        mid = count // 2
        # argpartition = O(n) median split of this range's ordering
        part = np.argpartition(c[:, axis], mid)
        order[start:end] = idxs[part]
        l, r = alloc(), alloc()
        arrays.left[node] = l
        arrays.right[node] = r
        arrays.is_leaf[node] = 0
        stack.append((l, start, start + mid, depth + 1))
        stack.append((r, start + mid, end, depth + 1))
    return arrays, order


def build_bvh_for_triangles(
    tris, leaf_size: int = LEAF_SIZE, use_native: bool = True,
    row_size: int = 8,
) -> FlatBVH:
    """Build over a triangle soup — the native binned-SAH builder when the
    C++ library is available (see ``native/bvh_builder.cpp``), the NumPy
    median-split builder otherwise.

    ``row_size=8`` (default) prices SAH in 8-triangle leaf rows, which
    builds fuller leaves with fewer leaf visits (a choice made for an
    earlier packet-traversal kernel; the leaf shape for the GPU walk is
    still open).  0 restores the per-primitive SAH."""
    from ..scene.geometry import triangle_bounds

    lo, hi = triangle_bounds(tris)
    if use_native:
        from .native import build_bvh_best

        return build_bvh_best(lo, hi, leaf_size, row_size=row_size)
    return build_bvh(lo, hi, leaf_size)


def build_sbvh_for_triangles(
    tris, leaf_size: int = LEAF_SIZE, alpha: float = 1e-5,
    max_ref_factor: float = 1.8,
) -> FlatBVH:
    """SBVH (spatial-split) build over a triangle soup — true polygon
    clipping from the triangle vertices; requires the native library
    (falls back to the plain SAH builder with a log note otherwise).
    Spatial splits duplicate straddling references, so ``prim_idx`` may be
    longer than the triangle count and contain repeats; every traversal
    consumer (leaf packing, stackless walk, the NumPy oracle) tolerates
    duplicates — re-testing a triangle is idempotent for closest-hit."""
    from ..scene.geometry import triangle_bounds

    lo, hi = triangle_bounds(tris)
    try:
        from .native import build_sbvh_native

        import numpy as _np

        v0 = _np.asarray(tris.v0, _np.float32)
        v1 = v0 + _np.asarray(tris.e1, _np.float32)
        v2 = v0 + _np.asarray(tris.e2, _np.float32)
        return build_sbvh_native(
            _np.asarray(lo), _np.asarray(hi), v0, v1, v2,
            leaf_size=leaf_size, alpha=alpha,
            max_ref_factor=max_ref_factor,
        )
    except RuntimeError:
        from ..utils.metrics import logger

        logger.info("native SBVH unavailable; using plain SAH builder")
        return build_bvh_for_triangles(tris, leaf_size)


def build_mixed_bvh(spheres, tris=None, leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """One tree over spheres AND triangles (mixed-primitive leaves).

    Sphere s occupies prim id s with AABB center±radius; triangle t occupies
    prim id n_sph + t.  Traverse with
    :func:`spira_tpu.accel.traverse.intersect_bvh_mixed` — sphere-heavy
    scenes then stop brute-forcing every sphere per ray.
    """
    from ..scene.geometry import triangle_bounds

    centers = np.asarray(spheres.centers, np.float64)
    radii = np.asarray(spheres.radii, np.float64)[:, None]
    lo = [centers - radii]
    hi = [centers + radii]
    if tris is not None and tris.count > 0:
        tlo, thi = triangle_bounds(tris)
        lo.append(np.asarray(tlo))
        hi.append(np.asarray(thi))
    arrays, order = _build_arrays(
        np.concatenate(lo), np.concatenate(hi), leaf_size
    )
    leaf = np.asarray(arrays.is_leaf) == 1
    max_leaf = int(np.asarray(arrays.right)[leaf].max())
    return add_links(FlatBVH(
        node_min=jnp.asarray(np.asarray(arrays.node_min, np.float32)),
        node_max=jnp.asarray(np.asarray(arrays.node_max, np.float32)),
        left=jnp.asarray(np.asarray(arrays.left, np.int32)),
        right=jnp.asarray(np.asarray(arrays.right, np.int32)),
        is_leaf=jnp.asarray(np.asarray(arrays.is_leaf, np.int32)),
        prim_idx=jnp.asarray(order.astype(np.int32)),
        max_leaf=max_leaf,
        n_sph=int(spheres.count),
    ))


def build_two_level(
    mesh_triangle_list, leaf_size: int = LEAF_SIZE, use_native: bool = True,
    row_size: int = 8,
):
    """Build per-mesh BVHs plus a top-level tree over mesh bounds and stitch
    them into one flat array.

    Per-mesh trees use the native binned-SAH builder when available
    (``use_native``, ~20-40% fewer traversal visits than median split on
    real meshes); the top tree over mesh bounds is tiny and stays NumPy.
    ``row_size=8`` (default) prices SAH in 8-triangle leaf rows — see
    :func:`build_bvh_for_triangles`; 0 restores per-primitive SAH.

    Returns (FlatBVH, Triangles): node/prim indices are rebased so the result
    traverses identically to a single-level tree, and the concatenated
    triangle soup to index with it.
    """
    from ..scene.geometry import concat_triangles, triangle_bounds

    mesh_lo, mesh_hi = [], []
    for tris in mesh_triangle_list:
        lo, hi = triangle_bounds(tris)
        mesh_lo.append(lo.min(axis=0))
        mesh_hi.append(hi.max(axis=0))

    top, top_order = _build_arrays(
        np.asarray(mesh_lo), np.asarray(mesh_hi), leaf_size=1
    )

    # Stitch: top-tree leaves (each holding exactly one mesh m) become
    # redirections to that mesh's rebased root node.
    n_top = len(top.left)
    node_min = [np.asarray(top.node_min)]
    node_max = [np.asarray(top.node_max)]
    left = [np.asarray(top.left)]
    right = [np.asarray(top.right)]
    is_leaf = [np.asarray(top.is_leaf)]

    node_base = n_top
    prim_base = 0
    mesh_root = {}
    prim_idx_parts = []
    tri_parts = []
    for m, tris in enumerate(mesh_triangle_list):
        lo, hi = triangle_bounds(tris)
        if use_native:
            from .native import build_bvh_best

            sub = build_bvh_best(lo, hi, leaf_size, row_size=row_size)
            arrays = _BuildArrays(
                node_min=np.asarray(sub.node_min),
                node_max=np.asarray(sub.node_max),
                left=np.asarray(sub.left),
                right=np.asarray(sub.right),
                is_leaf=np.asarray(sub.is_leaf),
            )
            order = np.asarray(sub.prim_idx, np.int64)
        else:
            arrays, order = _build_arrays(lo, hi, leaf_size)
        k = len(arrays.left)
        a_left = np.asarray(arrays.left)
        a_right = np.asarray(arrays.right)
        a_leaf = np.asarray(arrays.is_leaf)
        # rebase child indices / prim offsets
        a_left = np.where(a_leaf == 1, a_left + prim_base, a_left + node_base)
        a_right = np.where(a_leaf == 1, a_right, a_right + node_base)
        node_min.append(np.asarray(arrays.node_min))
        node_max.append(np.asarray(arrays.node_max))
        left.append(a_left)
        right.append(a_right)
        is_leaf.append(a_leaf)
        mesh_root[m] = node_base
        prim_idx_parts.append(order + prim_base)
        tri_parts.append(tris)
        node_base += k
        prim_base += order.shape[0]

    left_all = np.concatenate(left)
    right_all = np.concatenate(right)
    leaf_all = np.concatenate(is_leaf)
    # Redirect top leaves: a top leaf over mesh m becomes an internal node
    # whose both children are mesh m's root (count==1 leaves guaranteed by
    # leaf_size=1 when meshes > 1; single-mesh top tree is itself one leaf).
    for i in range(n_top):
        if leaf_all[i] == 1:
            m = int(top_order[left_all[i]])
            left_all[i] = mesh_root[m]
            right_all[i] = mesh_root[m]
            leaf_all[i] = 2  # redirect marker, resolved below

    # Resolve redirect markers by splicing: traversal treats node with
    # is_leaf==0 and left==right as "push one child".
    leaf_all = np.where(leaf_all == 2, 0, leaf_all)

    max_leaf = int(right_all[leaf_all == 1].max())
    bvh = add_links(FlatBVH(
        node_min=jnp.asarray(np.concatenate(node_min), jnp.float32),
        node_max=jnp.asarray(np.concatenate(node_max), jnp.float32),
        left=jnp.asarray(left_all, jnp.int32),
        right=jnp.asarray(right_all, jnp.int32),
        is_leaf=jnp.asarray(leaf_all, jnp.int32),
        prim_idx=jnp.asarray(np.concatenate(prim_idx_parts), jnp.int32),
        max_leaf=max_leaf,
    ))
    return bvh, concat_triangles(tri_parts)


def validate_bvh(bvh: FlatBVH, lo: np.ndarray, hi: np.ndarray) -> None:
    """Structural invariants (host-side debug aid): every primitive appears
    exactly once; leaf boxes contain their primitives; children within
    parents."""
    prim = np.asarray(bvh.prim_idx)
    assert sorted(prim.tolist()) == list(range(len(prim))), "prim permutation"
    node_min = np.asarray(bvh.node_min)
    node_max = np.asarray(bvh.node_max)
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    is_leaf = np.asarray(bvh.is_leaf)
    eps = 1e-4
    for i in range(bvh.node_count):
        if is_leaf[i]:
            for p in prim[left[i] : left[i] + right[i]]:
                assert (lo[p] >= node_min[i] - eps).all(), (i, p)
                assert (hi[p] <= node_max[i] + eps).all(), (i, p)
        elif left[i] != right[i]:
            for ch in (left[i], right[i]):
                assert (node_min[ch] >= node_min[i] - eps).all(), (i, ch)
                assert (node_max[ch] <= node_max[i] + eps).all(), (i, ch)
