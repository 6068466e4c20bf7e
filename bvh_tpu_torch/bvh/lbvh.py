"""Morton codes and the LBVH build on tensors.

Counterpart of ``morton_codes``, ``_expand_bits_10``, ``_delta``,
``_karras_topology`` and ``build_lbvh`` in ``bvh_tpu/bvh/lbvh.py``: the
Karras 2012 radix tree over Morton-sorted centroids, its boxes and leaf
counts bottom-up, then the DFS renumbering into the entry/exit layout of
``FlatBvh``. Every step is a whole-array PyTorch operation, so the build
runs on the card without a copy to the host; its tables are array-equal to
the reference's.
"""

from __future__ import annotations

import torch

from .flat import LEAF, FlatBvh

# the two fixpoint sweeps of build_lbvh test their stop condition (one read
# on the host) every SWEEP_CHECK sweeps; a sweep after the fixpoint changes
# nothing
SWEEP_CHECK = 8


def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so there are two zero bits between each."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(centroids: torch.Tensor, scene_min: torch.Tensor,
                 scene_max: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes of centroids quantized to a 1024^3 grid (int32)."""
    extent = torch.clamp_min(scene_max - scene_min, 1e-30)
    q = (centroids - scene_min) / extent
    grid = torch.clamp((q * 1024.0).to(torch.int32), 0, 1023)
    x = _expand_bits_10(grid[..., 0])
    y = _expand_bits_10(grid[..., 1])
    z = _expand_bits_10(grid[..., 2])
    return (x << 2) | (y << 1) | z


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zero bits of the low 32 bits of an integer tensor (32 for 0),
    int64, with integer operations only (``jax.lax.clz`` on int32)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        z = (x >> (32 - s)) == 0
        n = n + z.to(torch.int64) * s
        x = torch.where(z, (x << s) & 0xFFFFFFFF, x)
    return n + (x == 0).to(torch.int64)


def _delta(codes: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
           n: int) -> torch.Tensor:
    """Common-prefix length of sorted keys i and j; -1 when j is out of
    range. Equal codes are told apart by the index bits (the 64-bit key
    ``code << 32 | position``)."""
    valid = (j >= 0) & (j < n)
    jc = j.clamp(0, n - 1)
    x = codes[i] ^ codes[jc]
    d = torch.where(x == 0, 32 + clz32(i ^ jc), clz32(x))
    return torch.where(valid, d, -1)


def _karras_topology(codes: torch.Tensor):
    """Children and parents of the radix tree over n sorted keys, int64.

    Node ids: internal 0..n-2, leaves n-1..2n-2 (leaf k = n-1+k).
    Returns (left, right, parent) over all 2n-1 nodes (-1 where none).
    """
    n = codes.shape[0]
    dev = codes.device
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)

    d = torch.sign(_delta(codes, i, i + 1, n) - _delta(codes, i, i - 1, n))
    d = torch.where(d == 0, 1, d)
    delta_min = _delta(codes, i, i - d, n)

    # range length: the largest l with delta(i, i + l*d) > delta_min, by a
    # descending-powers binary search of fixed length
    nbits = max(int(n - 1).bit_length(), 1)
    l = torch.zeros_like(i)
    for k in range(nbits, -1, -1):
        t = 1 << k
        ok = _delta(codes, i, i + (l + t) * d, n) > delta_min
        l = l + ok.to(torch.int64) * t
    j = i + l * d
    delta_node = _delta(codes, i, j, n)

    # split: the largest s < l with delta(i, i + s*d) > delta_node
    s = torch.zeros_like(i)
    for k in range(nbits, -1, -1):
        t = 1 << k
        cand = s + t
        ok = (cand < l) & (_delta(codes, i, i + cand * d, n) > delta_node)
        s = s + ok.to(torch.int64) * t
    gamma = i + s * d + torch.clamp_max(d, 0)

    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    left = torch.where(lo == gamma, (n - 1) + gamma, gamma)
    right = torch.where(hi == gamma + 1, n + gamma, gamma + 1)

    total = 2 * n - 1
    parent = torch.full((total,), -1, dtype=torch.int64, device=dev)
    parent[left] = i
    parent[right] = i
    left_full = torch.full((total,), -1, dtype=torch.int64, device=dev)
    right_full = torch.full((total,), -1, dtype=torch.int64, device=dev)
    left_full[:n - 1] = left
    right_full[:n - 1] = right
    return left_full, right_full, parent


def _fixpoint(body, state, done):
    """Applies ``body`` until ``done(state)``, testing every SWEEP_CHECK
    sweeps (``body`` must leave a finished state unchanged)."""
    while not bool(done(state)):
        for _ in range(SWEEP_CHECK):
            state = body(state)
    return state


def build_lbvh(shape_min: torch.Tensor, shape_max: torch.Tensor):
    """An LBVH over shape AABBs ``[n, D]``, on their device.

    Returns ``(flat, shape_to_node)`` like ``build_sah``: a DFS-layout
    ``FlatBvh`` of tensors (left child at i+1, skip pointers, 2n-1 nodes)
    and the shape -> leaf-node backlink, int32. The tables equal the
    reference's ``build_lbvh``.
    """
    n = shape_min.shape[0]
    if n == 0:
        raise ValueError("build_lbvh requires at least one shape")
    # subtree leaf counts ride as float32 in the packed bottom-up record
    if n >= 1 << 24:
        raise ValueError(f"build_lbvh supports < 2^24 shapes (got {n})")
    dev = shape_min.device
    if n == 1:
        one = torch.ones(1, dtype=torch.int32, device=dev)
        flat = FlatBvh(aabb_min=shape_min, aabb_max=shape_max,
                       entry=one * LEAF, exit=one, shape=one * 0,
                       parent=one * -1)
        return flat, one * 0

    total = 2 * n - 1
    centroid = shape_min * 0.5 + shape_max * 0.5
    codes = morton_codes(centroid, shape_min.amin(dim=0),
                         shape_max.amax(dim=0))
    order = torch.argsort(codes, stable=True)
    codes = codes[order]

    left, right, parent = _karras_topology(codes)
    node = torch.arange(total, dtype=torch.int64, device=dev)
    is_leaf = node >= n - 1
    leaf_shape = torch.where(is_leaf, order[(node - (n - 1)).clamp(0, n - 1)],
                             -1)

    # bottom-up: subtree leaf counts and boxes, one packed [total, 2D+2]
    # record a node (amin, amax, count, ready)
    d = shape_min.shape[1]
    inf = torch.tensor(float("inf"), dtype=shape_min.dtype, device=dev)
    amin0 = torch.where(is_leaf[:, None], shape_min[leaf_shape.clamp_min(0)],
                        inf)
    amax0 = torch.where(is_leaf[:, None], shape_max[leaf_shape.clamp_min(0)],
                        -inf)
    flag = is_leaf.to(shape_min.dtype)[:, None]
    rec0 = torch.cat([amin0, amax0, flag, flag], dim=1)
    lc = left.clamp_min(0)
    rc = right.clamp_min(0)
    ones = torch.ones((total, 1), dtype=shape_min.dtype, device=dev)

    def up(rec):
        rl = rec[lc]
        rr = rec[rc]
        can = ((rec[:, -1] == 0.0) & ~is_leaf & (rl[:, -1] > 0.0)
               & (rr[:, -1] > 0.0))
        new = torch.cat([torch.minimum(rl[:, :d], rr[:, :d]),
                         torch.maximum(rl[:, d:2 * d], rr[:, d:2 * d]),
                         rl[:, 2 * d:2 * d + 1] + rr[:, 2 * d:2 * d + 1],
                         ones], dim=1)
        return torch.where(can[:, None], new, rec)

    # the root is node 0
    rec = _fixpoint(up, rec0, lambda r: r[0, -1] != 0.0)
    amin = rec[:, :d]
    amax = rec[:, d:2 * d]
    counts = rec[:, 2 * d].to(torch.int64)

    # top-down: DFS index and exit pointers, one [total, 2] record a node
    # dfs[left(p)] = dfs[p] + 1; dfs[right(p)] = dfs[p] + 2*counts[left(p)];
    # exit[left(p)] = dfs[right(p)]; exit[right(p)] = exit[p]; exit[0] = total
    p_safe = parent.clamp_min(0)
    lcount_p = counts[left[p_safe].clamp_min(0)]
    am_left = left[p_safe] == node
    dfs_off = torch.where(am_left, 1, 2 * lcount_p)
    de0 = torch.stack([torch.where(node == 0, 0, -1),
                       torch.where(node == 0, total, -1)], dim=1)

    def down(de):
        dp = de[p_safe]
        new_dfs = dp[:, 0] + dfs_off
        new_ex = torch.where(am_left, dp[:, 0] + 2 * lcount_p, dp[:, 1])
        upd = ((de[:, 0] < 0) & (dp[:, 0] >= 0) & (parent >= 0)
               & (am_left | (dp[:, 1] >= 0)))
        return torch.where(upd[:, None], torch.stack([new_dfs, new_ex], 1),
                           de)

    de = _fixpoint(down, de0, lambda de: (de[:, 0] >= 0).all())
    dfs, ex = de[:, 0], de[:, 1]

    # scatter into DFS order
    entry_old = torch.where(is_leaf, LEAF, dfs[left.clamp_min(0)])
    parent_old = torch.where(parent >= 0, dfs[p_safe], -1)

    def scat(src):
        out = torch.empty_like(src)
        out[dfs] = src
        return out

    i32 = torch.int32
    flat = FlatBvh(aabb_min=scat(amin), aabb_max=scat(amax),
                   entry=scat(entry_old).to(i32), exit=scat(ex).to(i32),
                   shape=scat(leaf_shape).to(i32),
                   parent=scat(parent_old).to(i32))
    leaf_ids = node[n - 1:]
    shape_to_node = torch.zeros(n, dtype=i32, device=dev)
    shape_to_node[leaf_shape[leaf_ids]] = dfs[leaf_ids].to(i32)
    return flat, shape_to_node
