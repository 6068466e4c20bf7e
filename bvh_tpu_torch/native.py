"""ctypes binding to the native host scene builder (the repository's
``csrc/``), built with ``g++`` into ``bvh_tpu_torch/_build/`` at first use.

The C++ output is required to be bit-identical to the numpy builder
(``bvh/sah_build.py``, ``ops/cluster.py``), which holds only with the
``-ffp-contract=off`` flag of ``csrc/Makefile`` (``ops/_build.py`` keeps it).
Unlike the JAX package's binding, the builds here do not fall back to numpy:
a caller that asks for the native build gets it or an error. Only
``build_sah_auto`` chooses, by the JAX package's rules
(``native_available``: whether the library builds and loads).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .bvh.flat import FlatBvh
from .ops._build import load_host_library

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int32)
_LP = ctypes.POINTER(ctypes.c_int64)
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32


@functools.cache
def load() -> ctypes.CDLL:
    """The host builder library, with every entry point's signature set."""
    lib = load_host_library()
    sigs = {
        "bvh_build_sah": (ctypes.c_int, [_FP, _FP, _I64, _FP, _FP, _IP, _IP,
                                         _IP, _IP, _IP, _I32]),
        "bvh_build_sah_hint": (ctypes.c_int, [_FP, _FP, _I64, _FP, _FP, _IP,
                                              _IP, _IP, _IP, _IP, _I32, _I32]),
        "bvh_tri_aabbs": (ctypes.c_int, [_FP, _FP, _FP, _I64, _FP, _FP]),
        "bvh_collapse": (ctypes.c_int, [_FP, _I64, _I32, _FP, _LP]),
        "bvh_build_sah_clusters": (ctypes.c_int64, [_FP, _FP, _I64, _I32, _FP,
                                                    _FP, _IP, _LP]),
        "bvh_pack_clusters": (ctypes.c_int, [_FP, _FP, _FP, _IP, _LP, _I64,
                                             _I32, _FP, _FP, _IP]),
        "bvh_build_wide": (ctypes.c_int64, [_FP, _I64, _I64, _I32, _FP, _I64,
                                            _IP, _IP]),
        "bvh_cut_tight": (ctypes.c_int64, [_IP, _IP, _I64, _I32, _IP]),
        "bvh_pack_tight": (ctypes.c_int, [_FP, _FP, _FP, _IP, _IP, _IP, _IP,
                                          _I64, _I32, _FP, _FP, _IP]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


@functools.cache
def native_available() -> bool:
    """Whether the host builder library builds (or is built) and loads;
    False, without raising, where it cannot (no ``g++``, a failed build).
    The answer is kept for the process."""
    try:
        load()
    except (OSError, RuntimeError):
        return False
    return True


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32)


def _ptr(arr: np.ndarray, typ):
    return arr.ctypes.data_as(typ)


def build_sah_native(shape_min, shape_max, nthreads: int = 0,
                     cluster_hint: int = 0):
    """SAH build over [n, 3] boxes on ``nthreads`` host threads (0: all
    cores); the tree does not depend on ``nthreads``.

    With ``cluster_hint`` 0 the build is exact: the same outputs as
    ``bvh.sah_build.build_sah``. With ``cluster_hint`` > 0, subtrees of at
    most that many shapes are split at the median instead: every cut of
    the tree into clusters of at most ``cluster_hint`` shapes keeps its
    cluster sets and bounds, only the leaf order inside a cluster changes.
    Only the tight-scene build, which dissolves everything below its
    cluster cut, passes it."""
    smin, smax = _f32(shape_min), _f32(shape_max)
    n, d = smin.shape
    if d != 3:
        raise ValueError("the native builder is 3-D only")
    total = 2 * n - 1
    amin = np.empty((total, 3), np.float32)
    amax = np.empty((total, 3), np.float32)
    entry, exit_, shape, parent = (np.empty(total, np.int32) for _ in range(4))
    s2n = np.empty(n, np.int32)
    args = (_ptr(smin, _FP), _ptr(smax, _FP), n, _ptr(amin, _FP),
            _ptr(amax, _FP), _ptr(entry, _IP), _ptr(exit_, _IP),
            _ptr(shape, _IP), _ptr(parent, _IP), _ptr(s2n, _IP), nthreads)
    if cluster_hint > 0:
        rc = load().bvh_build_sah_hint(*args, cluster_hint)
    else:
        rc = load().bvh_build_sah(*args)
    if rc != 0:
        raise RuntimeError(f"native SAH build failed with code {rc}")
    return FlatBvh(amin, amax, entry, exit_, shape, parent), s2n


def build_sah_auto(shape_min, shape_max, config=None, nthreads: int = 0,
                   cluster_hint: int = 0):
    """The native SAH build where it applies and the library is available
    (non-empty float32 [n, 3] boxes), else the numpy builder
    (``bvh/sah_build.py``), so that float64 boxes keep their resolution and
    2-D or 4-D boxes build at all. Both give the same tree where both apply
    (``cluster_hint`` 0); ``cluster_hint`` is the native build's (see
    ``build_sah_native``), which the numpy build ignores with the same
    cluster cuts. ``config`` is the numpy build's (default
    ``DEFAULT_CONFIG``). Returns ``(FlatBvh, shape_to_node)``."""
    smin = np.asarray(shape_min)
    if (smin.ndim == 2 and smin.shape[0] > 0 and smin.shape[1] == 3
            and smin.dtype != np.float64 and native_available()):
        return build_sah_native(shape_min, shape_max, nthreads,
                                cluster_hint=cluster_hint)
    from .bvh.sah_build import build_sah
    from .config import DEFAULT_CONFIG

    return build_sah(shape_min, shape_max, config or DEFAULT_CONFIG)


def tri_aabbs_native(a, b, c):
    """Per-triangle AABBs (min, max), each [n, 3]."""
    a, b, c = _f32(a), _f32(b), _f32(c)
    n = a.shape[0]
    mn = np.empty((n, 3), np.float32)
    mx = np.empty((n, 3), np.float32)
    load().bvh_tri_aabbs(_ptr(a, _FP), _ptr(b, _FP), _ptr(c, _FP), n,
                         _ptr(mn, _FP), _ptr(mx, _FP))
    return mn, mx


def build_sah_clusters_native(shape_min, shape_max, leaf_size: int):
    """Cluster-stopping SAH build: ``(cl_min, cl_max, tri_order, cl_off)``
    — per-cluster bounds [C, 3], the DFS-packed triangle ids [n] and the
    segment offsets [C + 1]."""
    smin, smax = _f32(shape_min), _f32(shape_max)
    n = smin.shape[0]
    cl_min = np.empty((n, 3), np.float32)
    cl_max = np.empty((n, 3), np.float32)
    tri_order = np.empty(n, np.int32)
    cl_off = np.empty(n + 1, np.int64)
    C = load().bvh_build_sah_clusters(
        _ptr(smin, _FP), _ptr(smax, _FP), n, leaf_size, _ptr(cl_min, _FP),
        _ptr(cl_max, _FP), _ptr(tri_order, _IP), _ptr(cl_off, _LP))
    if C <= 0:
        raise RuntimeError(f"native cluster build failed with code {C}")
    return (cl_min[:C].copy(), cl_max[:C].copy(), tri_order,
            cl_off[: C + 1].copy())


def pack_clusters_native(a, b, c, tri_order, cl_off, W: int, cc, groups,
                         tri_map) -> None:
    """Writes the cluster-relative group rows and the lane map into the
    caller's zero-filled ``groups`` and -1-filled ``tri_map``."""
    a, b, c, cc = _f32(a), _f32(b), _f32(c), _f32(cc)
    tri_order = np.ascontiguousarray(tri_order, np.int32)
    cl_off = np.ascontiguousarray(cl_off, np.int64)
    rc = load().bvh_pack_clusters(
        _ptr(a, _FP), _ptr(b, _FP), _ptr(c, _FP), _ptr(tri_order, _IP),
        _ptr(cl_off, _LP), cl_off.shape[0] - 1, W, _ptr(cc, _FP),
        _ptr(groups, _FP), _ptr(tri_map, _IP))
    if rc != 0:
        raise RuntimeError(f"native pack failed with code {rc} (cluster overflow?)")


def build_wide_native(smem_binary: np.ndarray, num_clusters: int, K: int = 16):
    """K-ary wide table ``(gnodes, gslot, depth)`` from the binary upper
    table; identical to ``ops.cluster.build_wide_table``'s numpy path."""
    tab = _f32(smem_binary)
    cap = max(3 * num_clusters + 64, 16)
    gnodes = np.empty((7 * K + 1, cap), np.float32)
    gslot = np.zeros(num_clusters, np.int32)
    depth = ctypes.c_int32(0)
    Gn = load().bvh_build_wide(
        _ptr(tab, _FP), tab.shape[1], num_clusters, K, _ptr(gnodes, _FP), cap,
        _ptr(gslot, _IP), ctypes.byref(depth))
    if Gn <= 0:
        raise RuntimeError(f"native wide-table build failed with code {Gn}")
    # the C++ writes a dense [7K+1, Gn] block into the flat buffer
    flat = gnodes.reshape(-1)[: (7 * K + 1) * Gn]
    return flat.reshape(7 * K + 1, Gn).copy(), gslot, int(depth.value)


def collapse_native(nodes: np.ndarray, K: int) -> np.ndarray:
    """K-ary collapse of an [8, nn] entry/exit table; identical to
    ``ops.cluster.collapse_upper``'s numpy path."""
    tab = _f32(nodes)
    out = np.empty_like(tab)
    out_nn = ctypes.c_int64(0)
    rc = load().bvh_collapse(_ptr(tab, _FP), tab.shape[1], K, _ptr(out, _FP),
                             ctypes.byref(out_nn))
    if rc != 0:
        raise RuntimeError(f"native collapse failed with code {rc}")
    return np.ascontiguousarray(out[:, : out_nn.value])


def cut_tight_native(entry, exit_, leaf_size: int) -> np.ndarray:
    """Cluster cut of a DFS entry/exit tree: the root node of every maximal
    subtree of at most ``leaf_size`` shapes, in DFS order (int32 [C]);
    identical to ``ops.cluster.cut_clusters``'s roots."""
    entry = np.ascontiguousarray(entry, np.int32)
    exit_ = np.ascontiguousarray(exit_, np.int32)
    total = entry.shape[0]
    roots = np.empty((total + 1) // 2, np.int32)
    C = load().bvh_cut_tight(_ptr(entry, _IP), _ptr(exit_, _IP), total,
                             leaf_size, _ptr(roots, _IP))
    if C < 0:
        raise RuntimeError(f"native cluster cut failed with code {C}")
    return roots[:C].copy()


def pack_tight_native(a, b, c, shape, entry, exit_, roots, W: int, cc,
                      groups, tri_map) -> None:
    """Writes the cluster-relative group rows and the lane map of the
    clusters rooted at ``roots`` of a full DFS tree into the caller's
    zero-filled ``groups`` and -1-filled ``tri_map``."""
    a, b, c, cc = _f32(a), _f32(b), _f32(c), _f32(cc)
    shape, entry, exit_, roots = (np.ascontiguousarray(x, np.int32)
                                  for x in (shape, entry, exit_, roots))
    rc = load().bvh_pack_tight(
        _ptr(a, _FP), _ptr(b, _FP), _ptr(c, _FP), _ptr(shape, _IP),
        _ptr(entry, _IP), _ptr(exit_, _IP), _ptr(roots, _IP), roots.shape[0],
        W, _ptr(cc, _FP), _ptr(groups, _FP), _ptr(tri_map, _IP))
    if rc != 0:
        raise RuntimeError(f"native pack failed with code {rc} (cluster overflow?)")
