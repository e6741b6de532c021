"""ctypes bindings for the native (C++) BVH builder.

The builder emits the exact flat layout of :class:`spira_tpu.accel.bvh.FlatBVH`
but with binned-SAH splits (better trees, ~10-50× faster builds than the
NumPy median-split builder on large meshes).  The library is built from the
committed sources in ``native/`` on first use, and rebuilt when it is older
than them, so a checkout never runs a binary built elsewhere.  When the
build or the load fails the NumPy builder takes over, with a warning;
:func:`last_builder` says which one built the most recent tree.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess

import jax.numpy as jnp
import numpy as np

from ..utils.metrics import logger
from .bvh import LEAF_SIZE, FlatBVH

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native")
)
_LIB_NAME = "libspira_native.so"

_lib = None
_lib_tried = False
_last_builder = None


def last_builder() -> str | None:
    """Which builder made the most recent tree: ``"native-sah"`` or
    ``"numpy-median"`` (None before the first build)."""
    return _last_builder


def _stale(path: str) -> bool:
    """True when the library is missing or older than a source file."""
    if not os.path.exists(path):
        return True
    sources = glob.glob(os.path.join(_NATIVE_DIR, "*.cpp")) + [
        os.path.join(_NATIVE_DIR, "Makefile")
    ]
    built = os.path.getmtime(path)
    return any(os.path.getmtime(src) > built for src in sources)


def _load_library():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    path = os.path.join(_NATIVE_DIR, _LIB_NAME)
    if _stale(path):
        try:
            subprocess.run(
                ["make", "-B", "-C", _NATIVE_DIR],
                check=True,
                capture_output=True,
                timeout=300,
            )
        except Exception as e:  # no toolchain / build failure → fallback
            logger.warning(
                "native build failed (%s); using the NumPy BVH builder", e
            )
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        logger.warning(
            "native load failed (%s); using the NumPy BVH builder", e
        )
        return None
    fn = lib.spira_build_bvh
    fn.restype = ctypes.c_int32
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # lo
        ctypes.POINTER(ctypes.c_float),  # hi
        ctypes.c_int32,  # n
        ctypes.c_int32,  # leaf_size
        ctypes.POINTER(ctypes.c_float),  # node_min
        ctypes.POINTER(ctypes.c_float),  # node_max
        ctypes.POINTER(ctypes.c_int32),  # left
        ctypes.POINTER(ctypes.c_int32),  # right
        ctypes.POINTER(ctypes.c_int32),  # is_leaf
        ctypes.POINTER(ctypes.c_int32),  # prim_idx
    ]
    pf = lib.spira_parse_obj
    pf.restype = ctypes.c_int32
    pf.argtypes = [
        ctypes.c_char_p,  # text
        ctypes.c_long,  # length
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),  # out_verts
        ctypes.POINTER(ctypes.c_long),  # out_nverts
        ctypes.POINTER(ctypes.POINTER(ctypes.c_longlong)),  # out_faces
        ctypes.POINTER(ctypes.c_long),  # out_nfaces
    ]
    lib.spira_free.restype = None
    lib.spira_free.argtypes = [ctypes.c_void_p]
    rf = lib.spira_build_bvh_rows
    rf.restype = ctypes.c_int32
    rf.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # lo
        ctypes.POINTER(ctypes.c_float),  # hi
        ctypes.c_int32,  # n
        ctypes.c_int32,  # leaf_size
        ctypes.c_int32,  # row (0 = per-primitive SAH)
        ctypes.POINTER(ctypes.c_float),  # node_min
        ctypes.POINTER(ctypes.c_float),  # node_max
        ctypes.POINTER(ctypes.c_int32),  # left
        ctypes.POINTER(ctypes.c_int32),  # right
        ctypes.POINTER(ctypes.c_int32),  # is_leaf
        ctypes.POINTER(ctypes.c_int32),  # prim_idx
    ]
    _lib = lib
    return _lib


def parse_obj_native(text: str):
    """Parse OBJ text with the C++ parser; returns (verts (V,3) f32,
    faces (T,3) i64, 0-based, fan-triangulated) or None when the native
    library (or the symbol) is unavailable / the text holds no triangles."""
    lib = _load_library()
    if lib is None:
        return None
    raw = text.encode("utf-8", errors="replace")
    vp = ctypes.POINTER(ctypes.c_float)()
    fp = ctypes.POINTER(ctypes.c_longlong)()
    nv = ctypes.c_long(0)
    nf = ctypes.c_long(0)
    rc = lib.spira_parse_obj(
        raw, len(raw), ctypes.byref(vp), ctypes.byref(nv),
        ctypes.byref(fp), ctypes.byref(nf),
    )
    if rc != 0:
        return None
    try:
        verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy()
        faces = np.ctypeslib.as_array(fp, shape=(nf.value, 3)).copy()
    finally:
        lib.spira_free(vp)
        lib.spira_free(fp)
    return verts.astype(np.float32), faces.astype(np.int64)


def native_available() -> bool:
    return _load_library() is not None


def build_bvh_native(
    lo: np.ndarray, hi: np.ndarray, leaf_size: int = LEAF_SIZE,
    row_size: int = 0,
) -> FlatBVH:
    """Binned-SAH build via the C++ library; raises if unavailable.

    ``row_size`` > 0 prices SAH costs in packet-kernel leaf ROWS
    (ceil(count/row_size)) instead of primitives, with an exact 3-axis
    sweep for small nodes — fuller leaves, fewer packet leaf visits (the
    kernel pays one fixed row of tests per visit)."""
    global _last_builder
    lib = _load_library()
    if lib is None:
        raise RuntimeError("native BVH builder unavailable")
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    cap = max(2 * n - 1, 1)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    is_leaf = np.empty(cap, np.int32)
    prim_idx = np.empty(n, np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    outs = (
        ptr(node_min, ctypes.c_float),
        ptr(node_max, ctypes.c_float),
        ptr(left, ctypes.c_int32),
        ptr(right, ctypes.c_int32),
        ptr(is_leaf, ctypes.c_int32),
        ptr(prim_idx, ctypes.c_int32),
    )
    if row_size:
        m = lib.spira_build_bvh_rows(
            ptr(lo, ctypes.c_float), ptr(hi, ctypes.c_float), n,
            leaf_size, row_size, *outs)
    else:
        m = lib.spira_build_bvh(
            ptr(lo, ctypes.c_float), ptr(hi, ctypes.c_float), n,
            leaf_size, *outs)
    if m < 0:
        raise RuntimeError("native BVH build failed")
    from .bvh import add_links

    _last_builder = "native-sah"
    leaf_mask = is_leaf[:m] == 1
    max_leaf = int(right[:m][leaf_mask].max())
    return add_links(FlatBVH(
        node_min=jnp.asarray(node_min[:m]),
        node_max=jnp.asarray(node_max[:m]),
        left=jnp.asarray(left[:m]),
        right=jnp.asarray(right[:m]),
        is_leaf=jnp.asarray(is_leaf[:m]),
        prim_idx=jnp.asarray(prim_idx),
        max_leaf=max_leaf,
    ))


def build_bvh_best(lo, hi, leaf_size: int = LEAF_SIZE,
                   row_size: int = 0) -> FlatBVH:
    """Native SAH builder when available, NumPy median-split otherwise.
    ``row_size`` (row-granular SAH) needs the native builder; the NumPy
    fallback ignores it (tree quality, not correctness)."""
    global _last_builder
    if native_available():
        return build_bvh_native(lo, hi, leaf_size, row_size=row_size)
    from .bvh import build_bvh

    _last_builder = "numpy-median"
    return build_bvh(lo, hi, leaf_size)


def build_sbvh_native(
    lo: np.ndarray,
    hi: np.ndarray,
    v0: np.ndarray | None = None,
    v1: np.ndarray | None = None,
    v2: np.ndarray | None = None,
    leaf_size: int = LEAF_SIZE,
    alpha: float = 1e-5,
    max_ref_factor: float = 1.8,
) -> FlatBVH:
    """SBVH build (binned SAH + spatial splits, Stich et al. HPG 2009) via
    the C++ library; raises if unavailable.

    Spatial splits duplicate straddling references into both children with
    clipped boxes (true polygon clipping when ``v0/v1/v2`` vertices are
    given), so ``prim_idx`` may exceed n and contain duplicates — every
    traversal consumer tolerates that (closest-hit re-tests are
    idempotent).  ``alpha`` is the SBVH overlap threshold relative to the
    root area; ``max_ref_factor`` caps reference inflation.
    """
    global _last_builder
    lib = _load_library()
    if lib is None:
        raise RuntimeError("native SBVH builder unavailable")
    if not hasattr(lib.spira_build_sbvh, "_typed"):
        f = lib.spira_build_sbvh
        f.restype = ctypes.c_int32
        f.argtypes = [ctypes.POINTER(ctypes.c_float)] * 5 + [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        f._typed = True
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    max_refs = max(int(n * max_ref_factor) + 8, n + 8)
    cap = 2 * max_refs - 1
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    is_leaf = np.empty(cap, np.int32)
    prim_idx = np.empty(max_refs, np.int32)
    n_refs = ctypes.c_int32(0)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    def vptr(a):
        if a is None:
            return ctypes.POINTER(ctypes.c_float)()
        return np.ascontiguousarray(a, np.float32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_float))

    # hold contiguous vertex copies alive across the call
    vs = [None if a is None else np.ascontiguousarray(a, np.float32)
          for a in (v0, v1, v2)]
    m = lib.spira_build_sbvh(
        ptr(lo, ctypes.c_float), ptr(hi, ctypes.c_float),
        vptr(vs[0]), vptr(vs[1]), vptr(vs[2]),
        n, leaf_size, ctypes.c_float(alpha), max_refs,
        ptr(node_min, ctypes.c_float), ptr(node_max, ctypes.c_float),
        ptr(left, ctypes.c_int32), ptr(right, ctypes.c_int32),
        ptr(is_leaf, ctypes.c_int32), ptr(prim_idx, ctypes.c_int32),
        ctypes.byref(n_refs),
    )
    if m < 0:
        raise RuntimeError("native SBVH build failed")
    from .bvh import add_links

    _last_builder = "native-sbvh"
    leaf_mask = is_leaf[:m] == 1
    max_leaf = int(right[:m][leaf_mask].max())
    return add_links(FlatBVH(
        node_min=jnp.asarray(node_min[:m]),
        node_max=jnp.asarray(node_max[:m]),
        left=jnp.asarray(left[:m]),
        right=jnp.asarray(right[:m]),
        is_leaf=jnp.asarray(is_leaf[:m]),
        prim_idx=jnp.asarray(prim_idx[: n_refs.value]),
        max_leaf=max_leaf,
    ))
