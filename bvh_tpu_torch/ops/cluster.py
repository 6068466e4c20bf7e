"""Host scene builds (numpy tables): tight scenes, legacy cluster scenes and
chained scenes.

Counterpart of ``bvh_tpu/ops/cluster.py`` (``TightScene``,
``build_tight_scene``, ``ClusterScene``, ``build_cluster_scene``,
``ChainedScene`` and ``build_chained_scene`` with their helpers). The
tables come out array-equal to the reference's, for the native and the
numpy build alike, because the trace kernels are held against the reference
on the same tables. Several rules below are limits of the TPU the reference
was written for (the ~660 KB scalar-memory budget that widens leaves, the
group-stack depth that drops the wide table, the parts of a chained scene);
they are kept so that the tables stay equal.

Leaves are SAH-cut clusters of at most ``W`` (16/32/64/128) triangles, stored
relative to the leaf box's centre as rows a', e1, e2 of ``groups
[G, 16, 128]``, cluster ``c`` at lanes ``(c mod 128/W)·W + j``. The upper
tree over the cluster boxes ships twice: as the entry/exit table
``smem_nodes [8, Nn]`` (walked by the sweep gate and the entry/exit trace)
and as the 16-ary wide table ``gnodes [113, Gn]`` (walked by the group-walk
trace). Options add the bf16-pair table ``packed_nodes [5, Nn]``, the
bilinear forms ``bgroups`` and the coarse sweep table ``sweep_nodes``.
"""

from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np
import torch

from ..bvh.sah_build import build_sah
from ..config import DEFAULT_CONFIG
from ..testbase import tri_aabbs

TIGHT = 16  # default triangles per cluster
GROUP = 128 // TIGHT  # clusters of TIGHT triangles in a 128-lane group row
CLUSTER = 128  # triangles per legacy (ClusterScene) cluster
WIDE_K = 16  # children per wide-tree group (bits of the fired mask)
TIGHT_VERSION = 3  # newest ``__tight_version__`` of a saved scene understood here
CLUSTER_VERSION = 1  # newest ``__version__`` of a saved ClusterScene understood here


class TightScene(NamedTuple):
    """Tables of a scene for the tight-cluster trace: numpy (host builds)
    or tensors (device builds, refits, updates).

    The reference's ``TightScene`` fields, then ``a_lo``, the port's own:
    [G, 3, 128] float32 laid out as the a' rows of ``groups``, the part of
    each triangle's ``a - cc`` that the stored ``a'`` (rounded to float32)
    leaves out (0 in pad lanes). Every scene the port builds or loads
    carries it: host builds, device builds, their refits, the updaters'
    parts and chains (``scene_from_arrays`` gives zeros to the reference's
    arrays, which hold no vertices). A ray whose origin lies ~1e5 from a
    leaf rounds ``o - cc`` at ~0.004 of a unit whoever built the scene, and
    a Morton cluster of a device build may also lie that far from its
    triangles, where ``a'`` rounds as much; the walks therefore test the
    leaves of every scene that carries ``a_lo`` in the exact cluster frame
    (``ops/wide.py::narrow_keys``'s ``frame``, the kernels' FRAME builds).
    None, which a caller may set, gives the builds without FRAME.
    """

    smem_nodes: np.ndarray  # [8, Nn] f32: amin(3), amax(3), entry, exit
    groups: np.ndarray  # [G, 16, 128] f32 rows: a'(3) e1(3) e2(3) pad(7)
    tri_map: np.ndarray  # [G * 128] i32 lane -> original triangle id (-1 pad)
    num_clusters: int
    num_nodes: int
    width: int = TIGHT  # triangles per cluster
    bgroups: np.ndarray | None = None  # [Gb, 16, row_w] bilinear forms (bmat)
    sweep_nodes: np.ndarray | None = None  # [8, Ns] coarse gate-sweep table
    packed_nodes: np.ndarray | None = None  # [5, Nn] bf16-pair node table
    gnodes: np.ndarray | None = None  # [7K+1, Gn] wide-tree table
    gslot: np.ndarray | None = None  # [C] i32 cluster -> g*K + k
    gdepth: int = 0  # wide-tree group-stack depth
    masked: bool = False  # lanes masked out after build
    a_lo: np.ndarray | None = None  # [G, 3, 128] f32: (a - cc) - a'

    @property
    def num_tris(self) -> int:
        return int((self.tri_map >= 0).sum())


class ClusterScene(NamedTuple):
    """Host tables of a scene for the legacy 128-triangle cluster trace
    (numpy). The reference's ``ClusterScene`` fields, then ``a_lo``.

    ``a_lo`` [C, 3, 128] float32 is the port's own: the part of each
    triangle's ``a - cc`` that the stored ``a'`` (rounded to float32) leaves
    out, which the walk adds back to ``a'`` in its float64 leaf test.
    ``build_cluster_scene`` computes it; a scene carried in by
    ``cluster_scene_from_arrays`` from the reference's arrays (which hold
    no vertices) gets zeros, which take the stored ``a'`` as exact.
    """

    smem_nodes: np.ndarray  # [8, Nc] f32: amin(3), amax(3), entry, exit
    smem_cc: np.ndarray  # [4, C] f32 cluster box centres (row 3 unused)
    tris_rel: np.ndarray  # [C, 16, 128] f32 rows: a'(3) e1(3) e2(3) pad(7)
    tri_map: np.ndarray  # [C * 128] i32 lane -> original triangle id (-1 pad)
    num_clusters: int
    num_nodes: int
    relative: bool  # triangle rows stored relative to the box centre
    a_lo: np.ndarray  # [C, 3, 128] f32: (a - cc) - a' (0 in pad lanes)

    @property
    def num_tris(self) -> int:
        return int((self.tri_map >= 0).sum())


def _morton10(x: np.ndarray) -> np.ndarray:
    """Spreads the low 10 bits of ``x`` three apart (uint32)."""
    v = x.astype(np.uint32)
    v = (v | (v << 16)) & np.uint32(0x030000FF)
    v = (v | (v << 8)) & np.uint32(0x0300F00F)
    v = (v | (v << 4)) & np.uint32(0x030C30C3)
    v = (v | (v << 2)) & np.uint32(0x09249249)
    return v


def _morton_order(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Triangle ids in the Morton order of their centroids on a 1024³ grid
    over the centroids' bounds (stable argsort)."""
    centroid = (a + b + c) / np.float32(3.0)
    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    q = (centroid - lo) / np.maximum(hi - lo, 1e-30)
    grid = np.clip((q * 1024.0).astype(np.int64), 0, 1023).astype(np.uint32)
    codes = ((_morton10(grid[:, 0]).astype(np.uint64) << np.uint64(2))
             | (_morton10(grid[:, 1]).astype(np.uint64) << np.uint64(1))
             | _morton10(grid[:, 2]).astype(np.uint64))
    return np.argsort(codes, kind="stable")


def build_cluster_scene(a: np.ndarray, b: np.ndarray, c: np.ndarray,
                        relative: bool = True) -> ClusterScene:
    """Host prep of the legacy scene: Morton-sort the triangles, cut the
    order into clusters of 128, build the SAH tree over the cluster boxes.

    ``relative=False`` stores the triangle rows in the global frame (no
    per-cluster origin; loses precision at 1e5 coordinates). Padding lanes
    of the last cluster are degenerate (e1 = e2 = 0), so they never hit.
    Beside the reference's fields, the scene holds ``a_lo`` (see
    ``ClusterScene``); pad lanes hold 0 there.
    """
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    c = np.asarray(c, np.float32)
    n = a.shape[0]
    if n == 0:
        raise ValueError("empty scene")
    order = _morton_order(a, b, c)

    pad = (-n) % CLUSTER
    n_pad = n + pad
    a_s = np.full((n_pad, 3), 1.0e30, np.float32)
    b_s = np.full((n_pad, 3), 1.0e30, np.float32)
    c_s = np.full((n_pad, 3), 1.0e30, np.float32)
    a_s[:n], b_s[:n], c_s[:n] = a[order], b[order], c[order]

    C = n_pad // CLUSTER
    # cluster boxes over the real triangles only
    mn, mx = tri_aabbs(a_s[:n], b_s[:n], c_s[:n])
    mn_pad = np.full((n_pad, 3), np.inf, np.float32)
    mx_pad = np.full((n_pad, 3), -np.inf, np.float32)
    mn_pad[:n], mx_pad[:n] = mn, mx
    cl_min = mn_pad.reshape(C, CLUSTER, 3).min(axis=1)
    cl_max = mx_pad.reshape(C, CLUSTER, 3).max(axis=1)
    cc = ((cl_min + cl_max) * 0.5).astype(np.float32)

    # the tree over the cluster boxes; leaves encode -(cluster+1) in entry
    flat, _ = build_sah(cl_min, cl_max)
    smem_nodes = _node_table(flat)
    smem_cc = np.zeros((4, C), np.float32)
    smem_cc[0:3] = cc.T

    ccl = np.repeat(cc, CLUSTER, axis=0) if relative else np.float32(0.0)
    a_rel = a_s - ccl
    # a' = a - cc rounded to float32 may sit 2^-8 off a - cc at ~4e4 units
    # from the centre, enough to open a crack between two triangles that
    # share an edge. a - cc and its remainder after a' are exact in float64
    # (float32 values within ~1e5 of each other), and the remainder is
    # exact again once rounded to float32
    a_lo = ((a_s.astype(np.float64) - ccl) - a_rel).astype(np.float32)
    e1 = b_s - a_s
    e2 = c_s - a_s
    if pad:
        a_rel[n:] = 0.0
        a_lo[n:] = 0.0
        e1[n:] = 0.0
        e2[n:] = 0.0
    tris_rel = np.zeros((C, 16, CLUSTER), np.float32)
    tris_rel[:, 0:3] = a_rel.reshape(C, CLUSTER, 3).transpose(0, 2, 1)
    tris_rel[:, 3:6] = e1.reshape(C, CLUSTER, 3).transpose(0, 2, 1)
    tris_rel[:, 6:9] = e2.reshape(C, CLUSTER, 3).transpose(0, 2, 1)

    tri_map = np.full(n_pad, -1, np.int32)
    tri_map[:n] = order.astype(np.int32)
    return ClusterScene(smem_nodes, smem_cc, tris_rel, tri_map, C,
                        flat.num_nodes, relative,
                        np.ascontiguousarray(
                            a_lo.reshape(C, CLUSTER, 3).transpose(0, 2, 1)))


def cut_clusters(flat, leaf_size: int = TIGHT):
    """Cuts a host FlatBvh into maximal subtrees of <= leaf_size shapes.

    Returns (roots, leaves, cluster_of_leaf): cluster root node indices in
    DFS order, the leaf node indices, and for every leaf its cluster.
    """
    entry = np.asarray(flat.entry)
    exit_ = np.asarray(flat.exit)
    parent = np.asarray(flat.parent)
    idx = np.arange(entry.shape[0], dtype=np.int64)
    count = (exit_ - idx + 1) // 2  # shapes under each node (2k-1 nodes <=> k shapes)
    small = count <= leaf_size
    psmall = np.where(parent >= 0, small[np.maximum(parent, 0)], False)
    roots = np.nonzero(small & ~psmall)[0]  # maximal small subtrees, DFS order
    # cluster roots partition DFS index space into [root, exit) intervals
    leaves = np.nonzero(entry == -1)[0]
    cluster_of_leaf = np.searchsorted(roots, leaves, side="right") - 1
    return roots, leaves, cluster_of_leaf


def collapse_upper(nodes: np.ndarray, K: int = 16,
                   use_native: bool = True) -> np.ndarray:
    """Collapses a binary DFS entry/exit node table to (up to) K-ary.

    Each kept internal absorbs children greedily by descending through the
    largest-surface-area binary internals first; children keep SAH (DFS)
    order. Input format == output format: [8, nn] f32 rows amin(3) amax(3)
    entry exit, leaves encode payloads as entry < 0. ``use_native`` runs
    the identical C++ version (``csrc/collapse.cpp``).
    """
    entry = nodes[6].astype(np.int64)
    exit_ = nodes[7].astype(np.int64)
    nn = nodes.shape[1]
    if nn <= 3 or K <= 2:
        return nodes
    if use_native:
        from ..native import collapse_native

        return collapse_native(nodes, K)

    s = nodes[3:6] - nodes[0:3]
    area = s[0] * s[1] + s[1] * s[2] + s[2] * s[0]

    def kids2(i):
        l = int(entry[i])
        return l, int(exit_[l])

    out_min, out_max, out_pay, out_kids = [], [], [], []
    stack = [(0, -1)]
    while stack:
        i, parent = stack.pop()
        oi = len(out_pay)
        out_min.append(nodes[0:3, i])
        out_max.append(nodes[3:6, i])
        out_pay.append(float(nodes[6, i]) if entry[i] < 0 else 0.0)
        out_kids.append([])
        if parent >= 0:
            out_kids[parent].append(oi)
        if entry[i] >= 0:
            heap: list = []
            leaves_acc: list = []
            cnt = 0

            def push(j):
                nonlocal cnt
                if entry[j] < 0:
                    leaves_acc.append(j)
                else:
                    heapq.heappush(heap, (-float(area[j]), cnt, j))
                    cnt += 1

            l, r = kids2(i)
            push(l)
            push(r)
            while heap and len(leaves_acc) + len(heap) < K:
                _, _, j = heapq.heappop(heap)
                l, r = kids2(j)
                push(l)
                push(r)
            frontier = leaves_acc + [j for _, _, j in heap]
            frontier.sort()  # restore SAH/DFS order among children
            for j in reversed(frontier):
                stack.append((j, oi))

    nn2 = len(out_pay)
    end = np.zeros(nn2, np.int64)
    for oi in range(nn2 - 1, -1, -1):
        end[oi] = oi + 1 if not out_kids[oi] else end[out_kids[oi][-1]]
    ent = np.zeros(nn2, np.float32)
    for oi in range(nn2):
        ent[oi] = float(out_kids[oi][0]) if out_kids[oi] else out_pay[oi]
    tab = np.zeros((8, nn2), np.float32)
    tab[0:3] = np.stack(out_min, axis=1)
    tab[3:6] = np.stack(out_max, axis=1)
    tab[6] = ent
    tab[7] = end.astype(np.float32)
    return tab


def _bucket(n: int, floor: int) -> int:
    """Shape-bucketed size: ``n`` rounded up to a multiple of a
    1/8-granularity power-of-two bucket (>= ``floor``)."""
    b = max(floor, 1 << max(int(n).bit_length() - 3, 0))
    return -(-int(n) // b) * b


def build_wide_table(smem_nodes: np.ndarray, num_clusters: int,
                     K: int = WIDE_K, use_native: bool = True):
    """Converts the BINARY upper entry/exit table into the group-walk
    tables ``(gnodes, gslot, depth)``: a K-ary wide tree cut level over level
    (every maximal subtree holding <= K frontier marks becomes a group).

    Layout: ``gnodes [7K+1, Gn]`` f32 — per group g, child k at rows
    7k..7k+6: amin(3), amax(3), payload. payload < 0 => leaf -(cluster+1);
    payload >= 0 => the child's group id. Empty slots hold NaN boxes and
    payload -1. Row 7K is the group's leaf mask (bit k set iff slot k is a
    leaf), stored as a float value. Group 0 is the root; children keep DFS
    (SAH) order. ``gslot [C]`` maps cluster -> g*K + k. ``use_native`` runs
    the identical C++ version (``csrc/pack.cpp``).
    """
    if use_native:
        from ..native import build_wide_native

        return build_wide_native(smem_nodes, num_clusters, K)

    entry = smem_nodes[6].astype(np.int64)
    exit_ = smem_nodes[7].astype(np.int64)
    nn = smem_nodes.shape[1]

    if entry[0] < 0:
        # single-leaf tree: one group whose only child is the root
        Gn = _bucket(1, 8)
        gnodes = np.full((7 * K + 1, Gn), np.nan, np.float32)
        gnodes[6:7 * K:7, :] = -1.0
        gnodes[7 * K, :] = 0.0
        gnodes[0:6, 0] = smem_nodes[0:6, 0]
        gnodes[6, 0] = smem_nodes[6, 0]
        gnodes[7 * K, 0] = 1.0  # leaf mask: bit 0
        gslot = np.zeros(num_clusters, np.int32)
        gslot[int(-smem_nodes[6, 0]) - 1] = 0
        return gnodes, gslot, 1

    # parents of the binary table: left = entry[i], right = exit[left]
    parent = np.full(nn, -1, np.int64)
    internal = np.nonzero(entry >= 0)[0]
    l = entry[internal]
    r = exit_[l]
    if not (r < exit_[internal]).all():
        raise ValueError("build_wide_table needs a binary table")
    parent[l] = internal
    parent[r] = internal

    idx = np.arange(nn, dtype=np.int64)
    marks = np.nonzero(entry < 0)[0]  # level 0: cluster leaves, DFS order
    levels = [marks]
    while not (len(marks) == 1 and marks[0] == 0):
        cnt = np.searchsorted(marks, exit_) - np.searchsorted(marks, idx)
        small = cnt <= K
        psmall = np.where(parent >= 0, small[np.maximum(parent, 0)], False)
        roots = np.nonzero(small & ~psmall & (cnt >= 1))[0]
        if not (len(roots) < len(marks) or len(roots) == 1):
            raise RuntimeError("hierarchical cut made no progress")
        levels.append(roots)
        marks = roots
    depth = len(levels) - 1

    # group ids are level-major, the root group first, DFS order in a level
    n_groups = sum(len(lv) for lv in levels[1:])
    offset = np.zeros(depth + 1, np.int64)  # level -> first gid
    acc = 0
    for lvl in range(depth, 0, -1):
        offset[lvl] = acc
        acc += len(levels[lvl])

    Gn = _bucket(n_groups, 8)
    gnodes = np.full((7 * K + 1, Gn), np.nan, np.float32)
    gnodes[6:7 * K:7, :] = -1.0  # empty-slot payload
    gnodes[7 * K, :] = 0.0  # leaf masks
    gslot = np.zeros(num_clusters, np.int32)
    gflat = gnodes.reshape(-1)
    for lvl in range(depth, 0, -1):
        roots = levels[lvl]
        prev = levels[lvl - 1]
        lo = np.searchsorted(prev, roots)
        hi = np.searchsorted(prev, exit_[roots])
        counts = hi - lo
        g = offset[lvl] + np.repeat(np.arange(len(roots), dtype=np.int64), counts)
        k = np.arange(len(prev), dtype=np.int64) - np.repeat(lo, counts)
        rows = (7 * k)[:, None] + np.arange(6)[:, None].T  # [n_ch, 6]
        gflat[(rows * Gn + g[:, None]).reshape(-1)] = \
            smem_nodes[0:6, prev].T.reshape(-1)
        if lvl == 1:
            pay = smem_nodes[6, prev].astype(np.float32)  # -(cluster+1)
            gslot[(-pay).astype(np.int64) - 1] = (g * K + k).astype(np.int32)
            np.add.at(gnodes[7 * K], g, (1 << k).astype(np.float32))
        else:
            pay = (offset[lvl - 1]
                   + np.arange(len(prev), dtype=np.int64)).astype(np.float32)
        gflat[(7 * k + 6) * Gn + g] = pay
    return gnodes, gslot, depth


def wide_group_meta(gnodes: np.ndarray):
    """``(parent, depth, anc)`` of every group of a wide table, int64.

    The root, group 0, has parent -1 and depth 0; ``anc [Gn, D]`` holds a
    group's ancestor at each depth (the group itself at its own depth, -1
    below it). Pad columns that no payload names get parent -1 and depth 0.
    The subtree-entry planners (``ops/trace.py``) read it. Counterpart of
    ``bvh_tpu/ops/cluster.py::wide_group_meta``, array-equal to it."""
    gn = np.asarray(gnodes)
    K = (gn.shape[0] - 1) // 7
    Gn = gn.shape[1]
    pay = gn[6:7 * K:7, :]  # [K, Gn] child payloads; interior ones >= 0
    inner = np.isfinite(pay) & (pay >= 0)
    _, gs = np.nonzero(inner)
    ch = pay[inner].astype(np.int64)
    parent = np.full(Gn, -1, np.int64)
    parent[ch] = gs
    if not (parent[ch] < ch).all():
        raise ValueError("the wide table does not list parents first")
    depth = np.zeros(Gn, np.int64)
    order = ch[np.argsort(ch)]  # parents before their children
    for g in order:
        depth[g] = depth[parent[g]] + 1
    D = int(depth.max()) + 1
    anc = np.full((Gn, D), -1, np.int64)
    anc[np.arange(Gn), depth] = np.arange(Gn)
    for g in order:
        anc[g, :depth[g]] = anc[parent[g], :depth[g]]
    return parent, depth, anc


def _pad_node_table(smem_nodes: np.ndarray, bucket: int = 2048,
                    target: int | None = None) -> np.ndarray:
    """Pads the entry/exit node table to a bucket multiple of columns. A
    walk reaches the first pad column through the tree's final exit
    pointer; its entry == exit == table width ends the walk."""
    nn = smem_nodes.shape[1]
    B = target if target is not None else -(-nn // bucket) * bucket
    if B < nn:
        raise ValueError(f"pad target {B} below the table width {nn}")
    if B == nn:
        return smem_nodes
    pad = np.zeros((8, B - nn), np.float32)
    pad[0:3] = 1.0e30  # point box far away (never a useful hit)
    pad[3:6] = 1.0e30
    pad[6] = float(B)  # entry: not a leaf, walks off the end
    pad[7] = float(B)
    return np.concatenate([smem_nodes, pad], axis=1)


def _node_table(up) -> np.ndarray:
    """[8, nn] entry/exit table of an upper FlatBvh; leaves encode
    -(cluster+1) in the entry row."""
    entry = np.asarray(up.entry, np.float32).copy()
    leaf_m = np.asarray(up.entry) < 0
    entry[leaf_m] = -(np.asarray(up.shape)[leaf_m].astype(np.float32) + 1.0)
    tab = np.zeros((8, up.num_nodes), np.float32)
    tab[0:3] = np.asarray(up.aabb_min).T
    tab[3:6] = np.asarray(up.aabb_max).T
    tab[6] = entry
    tab[7] = np.asarray(up.exit, np.float32)
    return tab


def build_tight_scene(
    a: np.ndarray, b: np.ndarray, c: np.ndarray, leaf_size: int | None = None,
    config=None, use_native: bool = True, collapse: int | None = 16,
    bmat: bool | None = None, sweep_cut: int | None = None,
    packed: bool = False, wide: bool = True,
) -> TightScene:
    """Host prep: SAH build, cluster cut, group-row pack, upper tables.

    ``leaf_size`` (16/32/64/128 triangles per cluster) defaults to 16,
    widening while the upper node table would exceed the reference's ~660 KB
    budget. ``use_native`` builds with the C++ builder (``native.py``),
    otherwise with the numpy builder; the two give the reference's tables of
    the same path. ``collapse`` is the arity of the entry/exit table (None
    keeps it binary). ``wide=False`` skips the group-walk table.

    ``packed``: also ship the node table as bf16 pairs
    (``pack_node_table_bf16``, 20 B a node against 32 in the budget); the
    group rows are then stored against the packed table's raw float value
    of the box rows as the cluster frame, and the scene has no wide table.
    ``bmat``: also precompute the leaf test's bilinear forms
    (``bilinear_blocks``) into ``bgroups``; the port's kernels carry them but
    evaluate the leaf test from ``groups`` (see ``ops/tight.py``).
    ``sweep_cut``: also build a coarse entry/exit table ``sweep_nodes`` over
    boxes of at most ``sweep_cut`` triangles for the sweep gate.

    Tie class (as in the reference): the two build paths may order lanes
    differently inside a cluster, so rays whose two best hits agree within
    the key truncation may report a different, equally valid ``shape_id``.
    """
    if config is None:
        config = DEFAULT_CONFIG
    if use_native:
        from ..native import (build_sah_clusters_native, build_sah_native,
                              cut_tight_native, pack_clusters_native,
                              pack_tight_native, tri_aabbs_native)
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    c = np.ascontiguousarray(c, np.float32)
    n = a.shape[0]
    if n == 0:
        raise ValueError("empty scene")
    bmat = bool(bmat)
    auto = leaf_size is None
    if auto:
        leaf_size = TIGHT if n <= (300_000 if collapse else 160_000) else 32
    if leaf_size not in (16, 32, 64, 128):
        raise ValueError("leaf_size must be 16/32/64/128")
    mn, mx = tri_aabbs_native(a, b, c) if use_native else tri_aabbs(a, b, c)
    # the native pack reads the cluster cut straight from the tree; the
    # numpy pack (and the bmat tables) need the leaf -> cluster map
    native_pack = use_native and not bmat
    # the fast path builds straight to the cluster cut (bit-identical
    # cluster sets, bounds and lane order to its own hinted full build +
    # cut); a second cut (sweep_cut), the packed frame or the numpy pack
    # need the full tree
    fast = native_pack and not sweep_cut and not packed
    flat = None
    if not fast:
        if use_native:
            # below the cluster cut the tree is dissolved by the pack, so
            # the native builder median-splits there (same cluster sets and
            # bounds, median lane order)
            flat, _ = build_sah_native(mn, mx, cluster_hint=leaf_size)
        else:
            flat, _ = build_sah(mn, mx, config)

    while True:
        if fast:
            cl_min, cl_max, tri_order, cl_off = build_sah_clusters_native(
                mn, mx, leaf_size)
            C = cl_min.shape[0]
        else:
            if native_pack:
                roots = cut_tight_native(flat.entry, flat.exit, leaf_size)
            else:
                roots, leaves, cluster_of_leaf = cut_clusters(flat, leaf_size)
            C = roots.shape[0]
            cl_min = np.asarray(flat.aabb_min)[roots]
            cl_max = np.asarray(flat.aabb_max)[roots]
        if packed:
            # the packed walk's frame origin is the raw float value of the
            # packed box rows at the leaf column (about the bf16 min corner)
            lo0 = _bf16_round_down(cl_min)
            hi0 = _bf16_round_up(cl_max)
            w = ((lo0.view(np.int32) & np.int32(~0xFFFF))
                 | ((hi0.view(np.int32) >> 16) & np.int32(0xFFFF)))
            cc = w.astype(np.int32).view(np.float32).astype(np.float32)
        else:
            cc = ((cl_min + cl_max) * 0.5).astype(np.float32)

        # upper BVH over the cluster boxes
        if use_native:
            up, _ = build_sah_native(cl_min, cl_max)
        else:
            up, _ = build_sah(cl_min, cl_max, config)
        smem_nodes = _node_table(up)
        smem_binary = smem_nodes  # pre-collapse binary table (wide-tree input)
        if collapse:
            smem_nodes = collapse_upper(smem_nodes, collapse, use_native)
        nn = smem_nodes.shape[1]
        # the reference's scalar-memory budget, checked on the padded table
        nn_pad = _bucket(nn, 256)
        node_bytes = 20 if packed else 32
        over = nn_pad * node_bytes > 660_000
        if over and not auto:
            raise ValueError(
                f"leaf_size={leaf_size} puts {nn_pad} (padded) upper nodes "
                f"({nn_pad * node_bytes} B) over the ~660KB node-table "
                "budget; use a larger leaf_size or leaf_size=None (auto)")
        if over and leaf_size >= 128:
            raise ValueError(
                f"scene needs {nn_pad} (padded) upper nodes even at "
                f"leaf_size=128 ({nn_pad * node_bytes} B > ~660KB node-table "
                "budget)")
        if not over:
            break
        leaf_size *= 2

    smem_nodes = _pad_node_table(
        smem_nodes, target=_bucket(int(smem_nodes.shape[1]), 256))

    # wide table; packed scenes have none, and it is dropped (as in the
    # reference) past group depth 14 or the node-table budget
    gnodes = gslot = None
    gdepth = 0
    if wide and not packed:
        gnodes, gslot, gdepth = build_wide_table(smem_binary, C,
                                                 use_native=use_native)
        if gdepth > 14 or gnodes.shape[0] * gnodes.shape[1] * 4 > 660_000:
            gnodes = gslot = None
            gdepth = 0

    sweep_nodes = None
    if sweep_cut:
        sweep_nodes = _sweep_table(flat, sweep_cut, config, use_native,
                                   collapse)

    W = leaf_size
    group = 128 // W
    G = _bucket((C + group - 1) // group, 16)

    if native_pack:
        groups = np.zeros((G, 16, 128), np.float32)
        tri_map_pad = np.full(G * 128, -1, np.int32)
        if fast:
            pack_clusters_native(a, b, c, tri_order, cl_off, W, cc, groups,
                                 tri_map_pad)
        else:
            pack_tight_native(a, b, c, flat.shape, flat.entry, flat.exit,
                              roots, W, cc, groups, tri_map_pad)
        pn = pack_node_table_bf16(smem_nodes) if packed else None
        return TightScene(smem_nodes, groups, tri_map_pad, C, nn, W,
                          sweep_nodes=sweep_nodes, packed_nodes=pn,
                          gnodes=gnodes, gslot=gslot, gdepth=gdepth,
                          a_lo=_host_a_lo(a, groups, tri_map_pad, cc, W))

    shape_ids = np.asarray(flat.shape)[leaves]  # tri id per tree leaf, DFS order
    # per-cluster contiguous triangle lists (DFS leaf order within a cluster)
    counts = np.bincount(cluster_of_leaf, minlength=C)
    slot = (np.arange(leaves.shape[0])
            - np.concatenate([[0], np.cumsum(counts)])[cluster_of_leaf])
    lane = cluster_of_leaf * W + slot  # [n] packed lane per triangle
    tri_map = np.full(C * W, -1, np.int32)
    tri_map[lane] = shape_ids.astype(np.int32)

    av = np.zeros((C * W, 3), np.float32)
    e1 = np.zeros((C * W, 3), np.float32)
    e2 = np.zeros((C * W, 3), np.float32)
    ccl = np.repeat(cc, W, axis=0)  # [C*W, 3]
    av[lane] = a[shape_ids] - ccl[lane]
    e1[lane] = b[shape_ids] - a[shape_ids]
    e2[lane] = c[shape_ids] - a[shape_ids]
    rows = np.zeros((G * group * W, 16), np.float32)  # [lane, row]
    rows[: C * W, 0:3] = av
    rows[: C * W, 3:6] = e1
    rows[: C * W, 6:9] = e2
    groups = rows.reshape(G, 128, 16).transpose(0, 2, 1).copy()  # [G, 16, 128]

    tri_map_pad = np.full(G * group * W, -1, np.int32)
    tri_map_pad[: C * W] = tri_map

    bgroups = None
    if bmat:
        blocks = bilinear_blocks(av.astype(np.float64), e1.astype(np.float64),
                                 e2.astype(np.float64)).astype(np.float32)
        # clusters padded to the group multiple
        C_pad = G * group
        if C_pad > C:
            blocks = np.concatenate(
                [blocks, np.zeros(((C_pad - C) * W, 4, 16), np.float32)])
        bgroups = pack_bgroups(blocks, C_pad, W)
    pn = pack_node_table_bf16(smem_nodes) if packed else None
    return TightScene(smem_nodes, groups, tri_map_pad, C, nn, W, bgroups,
                      sweep_nodes, pn, gnodes, gslot, gdepth,
                      a_lo=_host_a_lo(a, groups, tri_map_pad, cc, W))


def _host_a_lo(a, groups, tri_map, cc, W: int) -> np.ndarray:
    """A host build's ``TightScene.a_lo``: ``(a - cc) - a'`` of every lane
    of ``tri_map``, computed in float64 and rounded once to float32 (as
    ``build_cluster_scene`` and the device builds do), as [G, 3, 128] in
    the layout of the a' rows of ``groups``, 0 in pad lanes. Lane L holds
    a triangle of cluster ``L // W``, whose frame origin is ``cc[L // W]``
    (the leaf box's centre, or a packed scene's raw packed-row value)."""
    G = groups.shape[0]
    lanes = np.nonzero(tri_map >= 0)[0]
    av = groups[:, 0:3, :].transpose(0, 2, 1).reshape(G * 128, 3)[lanes]
    out = np.zeros((G * 128, 3), np.float32)
    out[lanes] = ((a[tri_map[lanes]].astype(np.float64) - cc[lanes // W])
                  - av).astype(np.float32)
    return np.ascontiguousarray(out.reshape(G, 128, 3).transpose(0, 2, 1))


def _sweep_table(flat, sweep_cut: int, config, use_native: bool,
                 collapse: int | None) -> np.ndarray:
    """The sweep gate's coarse entry/exit table: the upper tree over the
    boxes of the full tree cut at ``sweep_cut`` shapes, leaves marked -1
    (a fire marker without a payload), collapsed and padded like
    ``smem_nodes``. A miss in it proves a miss in the full table."""
    if use_native:
        from ..native import build_sah_native, cut_tight_native

        s_roots = cut_tight_native(flat.entry, flat.exit, sweep_cut)
    else:
        s_roots, _, _ = cut_clusters(flat, sweep_cut)
    s_min = np.asarray(flat.aabb_min)[s_roots]
    s_max = np.asarray(flat.aabb_max)[s_roots]
    if use_native:
        s_up, _ = build_sah_native(s_min, s_max)
    else:
        s_up, _ = build_sah(s_min, s_max, config)
    tab = _node_table(s_up)
    tab[6][np.asarray(s_up.entry) < 0] = -1.0
    if collapse:
        tab = collapse_upper(tab, collapse, use_native)
    return _pad_node_table(tab, target=_bucket(int(tab.shape[1]), 64))


def _cross(u, v):
    """u × v of [n, 3] rows, each component one product pair (np.cross's
    arithmetic)."""
    return torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                        u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                        u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=1)


def bilinear_blocks(av, e1, e2):
    """Per-triangle Moller-Trumbore bilinear forms [n, 4, 16] (block, row):
    the (det, u, v, t) rows whose product with the reference kernel's ray
    vector [d, m - cc x d, o - cc, 1, 0...] gives det, u·det, v·det and
    t·det, from the cluster-relative a' and the edges. numpy rows give a
    numpy array, tensors a tensor on their device."""
    av_t, e1_t, e2_t = (torch.as_tensor(x) for x in (av, e1, e2))
    p = _cross(e2_t, e1_t)
    q = _cross(e2_t, av_t)
    r = _cross(e1_t, av_t)
    nrm = _cross(e1_t, e2_t)
    an = ((av_t[:, 0] * nrm[:, 0] + av_t[:, 1] * nrm[:, 1])
          + av_t[:, 2] * nrm[:, 2])[:, None]
    z3 = torch.zeros_like(p)
    z7 = p.new_zeros((p.shape[0], 7))
    det = torch.cat([p, z3, z7, z3], dim=1)
    u = torch.cat([-q, e2_t, z7, z3], dim=1)
    v = torch.cat([r, -e1_t, z7, z3], dim=1)
    t = torch.cat([z3, z3, nrm, -an, z3, z3], dim=1)
    out = torch.stack([det, u, v, t], dim=1)
    return out if torch.is_tensor(av) else out.numpy()


def pack_bgroups(blocks, C: int, W: int):
    """Packs [C·W, 4, 16] bilinear blocks into rows [Gb, 16, row_w]: per
    cluster a [16, 4W] matrix (column block·W + triangle), ``128 // 4W``
    clusters to a 128-lane row (2 at W=16, else one cluster a row). numpy
    blocks give a numpy array, a tensor a tensor."""
    bt = torch.as_tensor(blocks)
    b = bt.reshape(C, W, 4, 16).permute(0, 2, 1, 3).reshape(C, 4 * W, 16)
    per_row = max(128 // (4 * W), 1)
    Gb = -(-C // per_row)
    pad = Gb * per_row - C
    if pad:
        b = torch.cat([b, b.new_zeros((pad, 4 * W, 16))])
    out = (b.reshape(Gb, per_row, 4 * W, 16).permute(0, 3, 1, 2)
           .reshape(Gb, 16, 4 * W * per_row).contiguous())
    return out if torch.is_tensor(blocks) else out.numpy()


def _bf16_round_down(x: np.ndarray) -> np.ndarray:
    """Largest bf16 <= x (directed rounding; f32 in and out)."""
    x = np.asarray(x, np.float32)
    t = x.view(np.int32) & np.int32(~0xFFFF)
    need = t.view(np.float32) > x
    # one bf16 step toward -inf in raw f32 bit space
    down = np.where(t > 0, t - 0x10000,
                    np.where(t == 0, np.int32(np.uint32(0x80010000)),
                             t + np.int32(0x10000))).astype(np.int32)
    return np.where(need, down, t).astype(np.int32).view(np.float32)


def _bf16_round_up(x: np.ndarray) -> np.ndarray:
    """Smallest bf16 >= x (directed rounding; f32 in and out)."""
    x = np.asarray(x, np.float32)
    t = x.view(np.int32) & np.int32(~0xFFFF)
    need = t.view(np.float32) < x
    neg0 = np.int32(np.uint32(0x80000000))
    up = np.where(t >= 0, t + 0x10000,
                  np.where(t == neg0, np.int32(0x00010000),
                           t - np.int32(0x10000))).astype(np.int32)
    return np.where(need, up, t).astype(np.int32).view(np.float32)


def pack_node_table_bf16(smem_nodes: np.ndarray) -> np.ndarray:
    """[8, Nn] float32 node table -> [5, Nn]: rows 0-2 hold each axis's
    (min, max) as two bf16 halves of one float32 word (min in the high
    half), rounded outward so a walk over the packed table visits a
    superset of the nodes; rows 3-4 are entry and exit unchanged."""
    nn = smem_nodes.shape[1]
    out = np.zeros((5, nn), np.float32)
    for axis in range(3):
        lo = _bf16_round_down(smem_nodes[axis])
        hi = _bf16_round_up(smem_nodes[3 + axis])
        word = ((lo.view(np.int32) & np.int32(~0xFFFF))
                | ((hi.view(np.int32) >> 16) & np.int32(0xFFFF)))
        out[axis] = word.astype(np.int32).view(np.float32)
    out[3] = smem_nodes[6]
    out[4] = smem_nodes[7]
    return out


def unpack_node_table_bf16(packed: np.ndarray) -> np.ndarray:
    """The [8, Nn] layout of a packed table (boxes at bf16 resolution)."""
    nn = packed.shape[1]
    out = np.zeros((8, nn), np.float32)
    for axis in range(3):
        bits = packed[axis].view(np.int32)
        out[axis] = (bits & np.int32(~0xFFFF)).view(np.float32)
        out[3 + axis] = (bits << 16).view(np.float32)
    out[6] = packed[3]
    out[7] = packed[4]
    return out


_INT_FIELDS = ("num_clusters", "num_nodes", "width", "gdepth")


def scene_from_arrays(fields) -> TightScene:
    """A ``TightScene`` from a mapping of numpy arrays and ints under its
    field names: the ``_asdict()`` of a scene the JAX package built, or the
    npz its ``save_tight_scene`` writes (``np.load(path)``).

    Missing optional fields become None, 0-d arrays become ints, and
    ``__tight_version__`` is checked, then dropped. Without ``a_lo`` (the
    reference's arrays, which hold no vertices) the scene gets zeros
    there: the stored ``a'`` is taken as exact, and the walks still form
    ``o - cc`` exactly (the FRAME builds).
    """
    f = dict(fields)
    version = f.pop("__tight_version__", None)
    if version is not None and int(version) > TIGHT_VERSION:
        raise ValueError(f"tight scene version {int(version)} is newer than "
                         f"supported ({TIGHT_VERSION})")
    unknown = set(f) - set(TightScene._fields)
    if unknown:
        raise ValueError(f"not TightScene fields: {sorted(unknown)}")
    out = {}
    for name, val in f.items():
        if val is None:
            out[name] = None
        elif name in _INT_FIELDS:
            out[name] = int(np.asarray(val))
        elif name == "masked":
            out[name] = bool(np.asarray(val))
        else:
            out[name] = np.asarray(val)
    if "a_lo" not in out:
        out["a_lo"] = np.zeros((out["groups"].shape[0], 3, 128), np.float32)
    return TightScene(**out)


def cluster_scene_from_arrays(fields) -> ClusterScene:
    """A ``ClusterScene`` from a mapping of numpy arrays and ints under its
    field names: the ``_asdict()`` of a scene the JAX package built, or the
    npz its ``save_cluster_scene`` writes (``np.load(path)``).

    0-d arrays become ints (``relative`` a bool, True where it is missing);
    ``__version__`` is checked, then dropped. Without ``a_lo`` (the
    reference's arrays) the scene gets zeros there.
    """
    f = dict(fields)
    version = f.pop("__version__", None)
    if version is not None and int(version) > CLUSTER_VERSION:
        raise ValueError(f"cluster scene version {int(version)} is newer "
                         f"than supported ({CLUSTER_VERSION})")
    unknown = set(f) - set(ClusterScene._fields)
    if unknown:
        raise ValueError(f"not ClusterScene fields: {sorted(unknown)}")
    out = {}
    for name, val in f.items():
        if name in ("num_clusters", "num_nodes"):
            out[name] = int(np.asarray(val))
        elif name == "relative":
            out[name] = bool(np.asarray(val))
        else:
            out[name] = np.asarray(val)
    out.setdefault("relative", True)
    out.setdefault("a_lo", np.zeros((out["num_clusters"], 3, CLUSTER),
                                    np.float32))
    return ClusterScene(**out)


# ---- chained scenes ---------------------------------------------------------

class ChainedScene(NamedTuple):
    """A scene as Morton-ordered parts, each a full ``TightScene``, traced
    in turn with each ray's best hit so far bounding the next part.

    The reference cut big scenes into parts because one node table had to
    fit the TPU's scalar memory; the port keeps the parts as an input so
    that it gives the reference's results on every scene it builds.
    """

    parts: tuple  # TightScene per part
    orig_ids: tuple  # [i] int32 per part: part-local triangle id -> global id


def _pad_wide_table(gnodes: np.ndarray, target: int) -> np.ndarray:
    """Pads a wide table to ``target`` columns with unreachable groups: NaN
    boxes (never fire) and empty-slot payloads."""
    Gn = gnodes.shape[1]
    if target < Gn:
        raise ValueError(f"pad target {target} below the table width {Gn}")
    if target == Gn:
        return gnodes
    K = gnodes.shape[0] // 7
    pad = np.full((gnodes.shape[0], target - Gn), np.nan, np.float32)
    pad[6:7 * K:7, :] = -1.0
    pad[7 * K:, :] = 0.0
    return np.concatenate([gnodes, pad], axis=1)


def _repad_tight(s: TightScene, nn_t: int, G_t: int, Gn_t: int = 0) -> TightScene:
    """Pads a part's tables to the chain's common (node, group-row, wide)
    widths; ``a_lo`` takes zeros in the new group rows. Padding a padded
    node table is safe: the old pad block's entry/exit point at the first
    new pad column, which walks off the end. ``num_nodes`` keeps the
    logical count."""
    sn = s.smem_nodes
    if sn.shape[1] < nn_t:
        sn = _pad_node_table(sn, target=nn_t)
    g, tm, al = s.groups, s.tri_map, s.a_lo
    if g.shape[0] < G_t:
        g = np.concatenate(
            [g, np.zeros((G_t - g.shape[0], 16, 128), np.float32)], axis=0)
        tm = np.concatenate(
            [tm, np.full((G_t - s.groups.shape[0]) * 128, -1, np.int32)])
        if al is not None:
            al = np.concatenate(
                [al, np.zeros((G_t - al.shape[0], 3, 128), np.float32)])
    # the bf16 table is packed again only when the node table grew
    if s.packed_nodes is not None and sn is not s.smem_nodes:
        pn = pack_node_table_bf16(sn)
    else:
        pn = s.packed_nodes
    bg = s.bgroups
    if bg is not None:
        W = int(s.width)
        Gb_t = _bucket(G_t * (128 // W) // max(128 // (4 * W), 1), 1)
        if bg.shape[0] < Gb_t:
            bg = np.concatenate(
                [bg, np.zeros((Gb_t - bg.shape[0],) + bg.shape[1:],
                              np.float32)], axis=0)
    gn = s.gnodes
    if gn is not None and Gn_t and gn.shape[1] < Gn_t:
        gn = _pad_wide_table(gn, Gn_t)
    if (sn is s.smem_nodes and g is s.groups and bg is s.bgroups
            and gn is s.gnodes):
        return s
    return s._replace(smem_nodes=sn, groups=g, tri_map=tm, packed_nodes=pn,
                      bgroups=bg, gnodes=gn, a_lo=al)


def build_chained_scene(a, b, c, max_part: int | None = None,
                        leaf_size: int | None = None, config=None,
                        use_native: bool = True, collapse: int | None = 16,
                        bmat: bool | None = None,
                        packed: bool = False) -> ChainedScene:
    """Partition and per-part build of a scene as a ``ChainedScene``.

    Parts are equal slices of the triangles' Morton order (spatially
    compact), at most ``max_part`` triangles each (default 200,000, or
    400,000 with ``packed``), each built by ``build_tight_scene`` with the
    other options. A chain whose parts' automatic leaf widths diverge is
    rebuilt at the widest; then every part is padded to the largest node,
    group-row and wide table, and the wide tables are dropped from every
    part unless all parts have one.
    """
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    c = np.asarray(c, np.float32)
    n = a.shape[0]
    if n == 0:
        raise ValueError("empty scene")
    if max_part is None:
        max_part = 400_000 if packed else 200_000
    opts = dict(config=config, use_native=use_native, collapse=collapse,
                bmat=bmat, packed=packed)
    k = -(-n // max_part)
    if k == 1:
        scene = build_tight_scene(a, b, c, leaf_size=leaf_size, **opts)
        return ChainedScene((scene,), (np.arange(n, dtype=np.int32),))

    order = _morton_order(a, b, c)
    bounds = np.linspace(0, n, k + 1).astype(np.int64)
    ids = [order[bounds[i]:bounds[i + 1]].astype(np.int32) for i in range(k)]
    parts = [build_tight_scene(a[s], b[s], c[s], leaf_size=leaf_size, **opts)
             for s in ids]
    widths = {int(p.width) for p in parts}
    if len(widths) > 1:
        w_max = max(widths)
        parts = [p if int(p.width) == w_max else
                 build_tight_scene(a[s], b[s], c[s], leaf_size=w_max, **opts)
                 for p, s in zip(parts, ids)]
    nn_t = max(int(p.smem_nodes.shape[1]) for p in parts)
    G_t = max(int(p.groups.shape[0]) for p in parts)
    if all(p.gnodes is not None for p in parts):
        Gn_t = max(int(p.gnodes.shape[1]) for p in parts)
    else:
        Gn_t = 0
        parts = [p._replace(gnodes=None, gslot=None, gdepth=0) for p in parts]
    parts = [_repad_tight(p, nn_t, G_t, Gn_t) for p in parts]
    return ChainedScene(tuple(parts), tuple(ids))


def chained_scene_from_parts(parts, orig_ids) -> ChainedScene:
    """A ``ChainedScene`` from per-part mappings as ``scene_from_arrays``
    takes them (each part's ``_asdict()`` of a scene the JAX package built)
    and the per-part global id arrays."""
    parts = tuple(scene_from_arrays(p) for p in parts)
    ids = tuple(np.asarray(i, np.int32) for i in orig_ids)
    if len(parts) != len(ids):
        raise ValueError(f"{len(parts)} parts but {len(ids)} id arrays")
    return ChainedScene(parts, ids)
