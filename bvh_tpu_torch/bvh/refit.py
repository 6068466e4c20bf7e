"""Refit of a flat BVH on tensors: the same topology, the boxes recomputed
from moved shapes.

Counterpart of ``refit`` and ``update_shapes`` in ``bvh_tpu/bvh/refit.py``.
Every node's box is the join of the leaf boxes in its DFS interval
``[i, exit[i])``, taken from a sparse table (log2(n) doubling passes of
shifted min/max over the node axis, then two gathers), so the tree comes
out consistent and tight after any movement, with no sequential sweep.
min and max are exact, so the boxes equal the reference's bit for bit.
"""

from __future__ import annotations

import torch

from .flat import LEAF, FlatBvh
from .lbvh import clz32


def _sparse_levels(m0: torch.Tensor, x0: torch.Tensor, levels: int):
    """The doubling tables of a column-wise min (of ``m0``) and max (of
    ``x0``), stacked: level k at rows k*n..(k+1)*n-1 holds the min and max
    over the window [i, i + 2^k), rows past the end counting as empty."""
    n, d = m0.shape
    mins, maxs = [m0], [x0]
    for k in range(1, levels + 1):
        step = 1 << (k - 1)
        pm, px = mins[-1], maxs[-1]
        if step >= n:
            mins.append(pm)
            maxs.append(px)
            continue
        inf = torch.full((step, d), float("inf"), dtype=pm.dtype,
                         device=pm.device)
        mins.append(torch.minimum(pm, torch.cat([pm[step:], inf])))
        maxs.append(torch.maximum(px, torch.cat([px[step:], -inf])))
    return torch.cat(mins), torch.cat(maxs)


def interval_rows(lo: torch.Tensor, hi: torch.Tensor, n: int):
    """Where ``_sparse_levels``' stacked table over ``n`` columns holds the
    intervals [lo, hi) (int64 tensors): the level k = floor(log2(hi - lo))
    from clz (level 0 for an empty interval), and the rows of the two
    windows of 2^k columns that start at lo and end at hi, clamped to the
    table."""
    k = 31 - clz32((hi - lo).clamp_min(1))
    return k, k * n + lo, k * n + torch.clamp_max(hi - (1 << k), n - 1)


def interval_join(m0: torch.Tensor, x0: torch.Tensor, levels: int,
                  rows_lo: torch.Tensor, rows_hi: torch.Tensor):
    """The column-wise min of ``m0`` and max of ``x0`` over the intervals
    whose rows ``interval_rows`` gave (``levels`` at least their largest
    level)."""
    allm, allx = _sparse_levels(m0, x0, levels)
    return (torch.minimum(allm[rows_lo], allm[rows_hi]),
            torch.maximum(allx[rows_lo], allx[rows_hi]))


def refit(flat: FlatBvh, shape_min: torch.Tensor,
          shape_max: torch.Tensor) -> FlatBvh:
    """Every node box recomputed from (possibly moved) shape AABBs
    ``[n_shapes, D]``: a ``FlatBvh`` with the same topology and tight
    boxes, on ``shape_min``'s device (numpy node arrays are copied there)."""
    dev = shape_min.device
    flat = FlatBvh(*(torch.as_tensor(x).to(dev) for x in flat))
    n = flat.num_nodes
    if n == 0:
        return flat
    is_leaf = flat.entry == LEAF
    sid = flat.shape.clamp_min(0).to(torch.int64)
    inf = float("inf")
    # level 0: the leaf boxes; internal columns empty, so that an interval
    # reduction sees leaves only
    m0 = torch.where(is_leaf[:, None], shape_min[sid], inf)
    x0 = torch.where(is_leaf[:, None], shape_max[sid], -inf)
    levels = max(int(n - 1).bit_length(), 0)  # the longest interval is n
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    _, rows_lo, rows_hi = interval_rows(idx, flat.exit.to(torch.int64), n)
    amin, amax = interval_join(m0, x0, levels, rows_lo, rows_hi)
    return flat._replace(aabb_min=amin, aabb_max=amax)


def update_shapes(flat: FlatBvh, shape_min: torch.Tensor,
                  shape_max: torch.Tensor) -> FlatBvh:
    """The reference's ``update_shapes`` contract: after moving any subset
    of shapes, a BVH that is consistent and tight (``refit``; the set of
    moved shapes is not needed)."""
    return refit(flat, shape_min, shape_max)
