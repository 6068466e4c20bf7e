"""The work model's own tree: a binary BVH over the configuration's
triangles, built as the upstream crate builds its BVH (binned SAH with 6
buckets along the largest axis of the centroid bounds, one triangle a
leaf; a node whose centroids coincide is split in the middle of its
list). numpy, one level of the tree at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

BUCKETS = 6


class Tree(NamedTuple):
    """Nodes in breadth-first order, the root first: boxes ``lo``, ``hi``
    [M, 3] float32, children ``left``, ``right`` [M] int64 (-1 at a leaf),
    the leaf's triangle ``prim`` [M] int64 (-1 at an interior node), and
    ``depth``, the number of levels."""

    lo: np.ndarray
    hi: np.ndarray
    left: np.ndarray
    right: np.ndarray
    prim: np.ndarray
    depth: int


def _area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def build(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> Tree:
    """The binned-SAH tree over triangles ``a, b, c`` ([N, 3])."""
    tlo = np.minimum(np.minimum(a, b), c).astype(np.float64)
    thi = np.maximum(np.maximum(a, b), c).astype(np.float64)
    cen = (tlo + thi) * 0.5
    n = len(a)
    m = 2 * n - 1
    lo, hi = np.zeros((m, 3)), np.zeros((m, 3))
    left, right = np.full(m, -1, np.int64), np.full(m, -1, np.int64)
    prim = np.full(m, -1, np.int64)
    order = np.arange(n)  # the triangles, grouped by node of the frontier
    ids = np.zeros(1, np.int64)  # the frontier's node ids
    counts = np.array([n])
    next_id = 1
    depth = 0
    while len(ids):
        depth += 1
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        seg = np.repeat(np.arange(len(ids)), counts)
        lo[ids] = np.minimum.reduceat(tlo[order], offs)
        hi[ids] = np.maximum.reduceat(thi[order], offs)
        leaf = counts == 1
        prim[ids[leaf]] = order[offs[leaf]]
        inner = ~leaf
        if not inner.any():
            break
        # keep the inner nodes' triangles, in frontier order
        keep = inner[seg]
        order, seg = order[keep], seg[keep]
        f_ids, f_counts = ids[inner], counts[inner]
        remap = np.cumsum(inner) - 1
        seg = remap[seg]
        f = len(f_ids)
        f_offs = np.concatenate([[0], np.cumsum(f_counts)[:-1]])
        c_ = cen[order]
        cmin = np.minimum.reduceat(c_, f_offs)
        cmax = np.maximum.reduceat(c_, f_offs)
        axis = np.argmax(cmax - cmin, axis=1)
        ext = (cmax - cmin)[np.arange(f), axis]
        x = c_[np.arange(len(order)), axis[seg]]
        flat = ext <= 0
        ext_ = np.where(flat, 1.0, ext)
        bucket = np.clip(((x - cmin[seg, axis[seg]]) / ext_[seg]
                          * BUCKETS).astype(np.int64), 0, BUCKETS - 1)
        key = seg * BUCKETS + bucket
        srt = np.argsort(key, kind="stable")
        ks = key[srt]
        starts = np.concatenate([[0], np.nonzero(np.diff(ks))[0] + 1])
        present = ks[starts]
        blo = np.full((f * BUCKETS, 3), np.inf)
        bhi = np.full((f * BUCKETS, 3), -np.inf)
        blo[present] = np.minimum.reduceat(tlo[order[srt]], starts)
        bhi[present] = np.maximum.reduceat(thi[order[srt]], starts)
        bcnt = np.bincount(key, minlength=f * BUCKETS).reshape(f, BUCKETS)
        blo, bhi = blo.reshape(f, BUCKETS, 3), bhi.reshape(f, BUCKETS, 3)
        # split k puts buckets < k on the left, k = 1 .. BUCKETS - 1
        llo = np.minimum.accumulate(blo, axis=1)[:, :-1]
        lhi = np.maximum.accumulate(bhi, axis=1)[:, :-1]
        rlo = np.minimum.accumulate(blo[:, ::-1], axis=1)[:, ::-1][:, 1:]
        rhi = np.maximum.accumulate(bhi[:, ::-1], axis=1)[:, ::-1][:, 1:]
        lcnt = np.cumsum(bcnt, axis=1)[:, :-1]
        rcnt = f_counts[:, None] - lcnt
        cost = np.where((lcnt > 0) & (rcnt > 0),
                        lcnt * _area(llo, lhi) + rcnt * _area(rlo, rhi),
                        np.inf)
        k = np.argmin(cost, axis=1) + 1
        go_left = bucket < k[seg]
        # coincident centroids: the first half of the node's list goes left
        pos = np.arange(len(order)) - f_offs[seg]
        go_left = np.where(flat[seg], pos < f_counts[seg] // 2, go_left)
        part = np.lexsort((~go_left, seg))
        order, go_left, seg = order[part], go_left[part], seg[part]
        n_left = np.bincount(seg, weights=go_left, minlength=f).astype(np.int64)
        left[f_ids] = next_id + 2 * np.arange(f)
        right[f_ids] = next_id + 2 * np.arange(f) + 1
        next_id += 2 * f
        ids = np.stack([left[f_ids], right[f_ids]], axis=1).reshape(-1)
        counts = np.stack([n_left, f_counts - n_left], axis=1).reshape(-1)
    return Tree(lo.astype(np.float32), hi.astype(np.float32), left, right,
                prim, depth)
