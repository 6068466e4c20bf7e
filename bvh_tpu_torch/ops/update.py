"""Incremental update that keeps the scene's quality: mask + delta.

Counterpart of ``bvh_tpu/ops/update.py`` (``_delta_layout``,
``make_updater``, ``make_chained_updater``). The reference's
``Bvh::update_shapes`` removes every moved shape and inserts it again at
its SAH seam; a refit with fixed topology (``device_build.make_refitter``)
instead drags a moved triangle's whole cluster box across the scene. Here:

1. remove: the moved triangles' lanes in the static part's group rows are
   zeroed (a degenerate triangle never passes the leaf test). No box table
   changes; a box that lost members is still a bound, so the static part
   keeps its host-SAH quality;
2. insert: the moved triangles are built on the device into a small delta
   part (``device_build._build_core`` over a buffer of fixed capacity);
3. trace chained: the static part first, its best t then bounds the delta
   (``ops/trace.py::trace_closest_hit_chained``).

An update is taken against the ORIGINAL scene with the cumulative set of
moved triangles, so a frame costs one lane scatter and one delta build of
at most ``max_moved`` triangles, and nothing leaves the device. The static
part is marked ``masked``: its boxes may hold no live triangle, so nearest
queries do not refine their bound from them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bvh.lbvh import morton_codes
from ..device import resolve_device
from .cluster import TIGHT, ChainedScene, TightScene
from .device_build import (_SMEM_BUDGET, _THIRD, _build_core, _dev,
                           _grid_layout, _grid_wide_meta, _grid_wide_ok, _np,
                           _vertices)

# one delta part's entry/exit table fits _SMEM_BUDGET (the reference's
# split, so that the port splits a delta where the reference does)
_NODE_BYTES = 32  # a column of the [8, nn] grid table


def _delta_layout(max_moved: int, W: int):
    """``(slice_cap, D, Cd, nn_d)``: the delta buffer's capacity cut into the
    fewest equal lane-aligned slices whose grid table each fits the
    budget. D is 1 (one delta part) up to ~300k moved triangles at W = 16;
    more are Morton-partitioned into D parts of one shape."""
    cap = -(-max_moved // W) * W
    D = 1
    while True:
        slice_cap = -(-(cap // D) // W) * W
        Cd = slice_cap // W
        nn_d = int(_grid_layout(Cd)[0].shape[0])
        if nn_d * _NODE_BYTES <= _SMEM_BUDGET or slice_cap == W:
            return slice_cap, D, Cd, nn_d
        D += 1


def make_updater(scene: TightScene, max_moved: int, delta_width: int = TIGHT,
                 max_added: int = 0, device=None):
    """``update(a, b, c, moved_idx, alive=None) -> ChainedScene`` for a
    ``TightScene``.

    ``a, b, c``: the FULL new vertex arrays [n, 3] (numpy or tensors; only
    the rows listed in ``moved_idx`` are read). ``moved_idx``: int32
    [<= max_moved + max_added], the cumulative set of triangles moved since
    the scene was built, padded with -1; an id may repeat (the delta then
    tests the triangle twice). The result has the static part (the scene,
    its moved lanes masked, every box table as it was) and the delta
    part(s) over the moved triangles, and plugs into
    ``trace_closest_hit_chained``, ``trace_any_hit_chained`` and
    ``nearest_chained``. Every table it makes is a tensor on ``device``
    (None: the card).

    A capacity beyond one delta table of the reference's budget is split
    into D Morton-ordered delta parts of one shape (``_delta_layout``).
    Growth: with ``max_added`` > 0, ids ``n <= id < n + max_added`` of the
    extended vertex arrays are new triangles and go into the delta like
    moved ones; ``alive=False`` for an entry removes it (its static lane is
    masked, and it stays out of the delta). Capacity: ``max_moved +
    max_added`` delta slots. For a ``ChainedScene`` use
    ``make_chained_updater``.
    """
    dev = resolve_device(device)
    tri_map = _np(scene.tri_map)
    n_lanes = tri_map.shape[0]
    n = int(tri_map.max()) + 1
    if max_moved < 1:
        raise ValueError("max_moved must be >= 1")
    if max_added < 0:
        raise ValueError("max_added must be >= 0")
    n_total = n + max_added
    # original triangle id -> lane, over the grown id space: an added id
    # (>= n) maps to the spare row n_lanes, which is dropped
    lanes_of = np.full(n_total, n_lanes, np.int64)
    occ = tri_map >= 0
    lanes_of[tri_map[occ]] = np.nonzero(occ)[0]
    lanes_of_t = torch.as_tensor(lanes_of).to(dev)
    cap_in = max_moved + max_added

    groups_t = _dev(scene.groups, dev)
    G = groups_t.shape[0]
    W = delta_width
    slice_cap, D, Cd, nn_d = _delta_layout(cap_in, W)
    cap = slice_cap * D
    # a delta part carries the group-walk table where it fits (the grid's
    # topology is a host constant of its capacity; the boxes fill on the
    # device)
    wide_d = _grid_wide_ok(Cd)
    gslot_d, gdepth_d = None, 0
    if wide_d:
        _, _, _, gslot_np, gdepth_d = _grid_wide_meta(Cd)
        gslot_d = _dev(gslot_np, dev)

    def update_core(a, b, c, moved_idx, alive=None):
        a, b, c = _vertices(a, b, c, dev)
        moved = torch.as_tensor(moved_idx, device=dev).to(torch.int64)
        moved = moved.reshape(-1)
        mvalid = moved >= 0
        safe_m = moved.clamp_min(0)
        # alive=False: a removal, masked below and kept out of the delta
        dvalid = mvalid if alive is None else (
            mvalid & torch.as_tensor(alive, device=dev).to(torch.bool)
            .reshape(-1))

        # 1) the moved lanes of the static part's group rows, zeroed; ids
        # without a lane (-1 and added ones) go to the spare last row
        lanes = torch.where(mvalid, lanes_of_t[safe_m.clamp_max(n_total - 1)],
                            n_lanes)
        rows = torch.zeros((n_lanes + 1, 16), dtype=torch.float32, device=dev)
        rows[:n_lanes] = groups_t.permute(0, 2, 1).reshape(n_lanes, 16)
        rows.index_fill_(0, lanes, 0.0)
        masked_groups = (rows[:n_lanes].view(G, 128, 16).permute(0, 2, 1)
                         .contiguous())

        # 2) the delta part(s) over the moved triangles, in a buffer of
        # fixed capacity
        safe_b = torch.zeros(cap, dtype=torch.int64, device=dev)
        valid_b = torch.zeros(cap, dtype=torch.bool, device=dev)
        safe_b[:moved.shape[0]] = safe_m
        valid_b[:moved.shape[0]] = dvalid
        if D > 1:
            # many moved triangles: D spatially compact equal slices of
            # their Morton order
            cm = (a[safe_b] + b[safe_b] + c[safe_b]) * _THIRD
            any_v = valid_b.any()
            vb3 = valid_b[:, None]
            lo = torch.where(any_v, torch.where(vb3, cm, float("inf"))
                             .amin(dim=0), 0.0)
            hi = torch.where(any_v, torch.where(vb3, cm, -float("inf"))
                             .amax(dim=0), 0.0)
            codes = torch.where(valid_b, morton_codes(cm, lo, hi), 0x7FFFFFFF)
            ordm = torch.argsort(codes, stable=True)
            safe_b, valid_b = safe_b[ordm], valid_b[ordm]
        sl_s = safe_b.view(D, slice_cap)
        sl_v = valid_b.view(D, slice_cap)
        outs = [_build_core(a[sl_s[p]], b[sl_s[p]], c[sl_s[p]], W, "grid",
                            False, valid_in=sl_v[p], wide=wide_d)
                for p in range(D)]
        return masked_groups, outs, sl_s.to(torch.int32)

    def update(a, b, c, moved_idx, alive=None) -> ChainedScene:
        if np.shape(moved_idx)[0] > cap:
            raise ValueError(
                f"{np.shape(moved_idx)[0]} moved ids > capacity {cap} "
                f"(max_moved + max_added); rebuild the scene (or raise them)")
        masked_groups, outs, sl_s = update_core(a, b, c, moved_idx, alive)
        static = scene._replace(groups=masked_groups, bgroups=None,
                                masked=True)
        parts = [static] + [_delta_part(o) for o in outs]
        ids = [torch.arange(n, dtype=torch.int32, device=dev)] + list(sl_s)
        return ChainedScene(parts=tuple(parts), orig_ids=tuple(ids))

    def _delta_part(out) -> TightScene:
        smem_nodes, groups, tri_map, a_lo, _, gnodes = out
        return TightScene(smem_nodes, groups, tri_map, Cd, nn_d, W,
                          gnodes=gnodes, gslot=gslot_d, gdepth=gdepth_d,
                          a_lo=a_lo)

    update.core = update_core
    update.delta_part = _delta_part
    update.cap = cap
    update.delta_parts = D
    return update


def make_chained_updater(chained: ChainedScene, max_moved: int,
                         delta_width: int = TIGHT, device=None):
    """Mask + delta update of a ``ChainedScene``: ``update(a, b, c,
    moved_idx) -> ChainedScene`` with ``a, b, c`` the FULL new vertex
    arrays and ``moved_idx`` the cumulative moved set ([<= max_moved]
    int32, -1 padded, GLOBAL ids). Each static part gets its moved lanes
    masked, and its moved triangles are built on the device into a delta
    part traced right after it; every delta has one capacity."""
    dev = resolve_device(device)
    ids_np = [_np(i) for i in chained.orig_ids]
    n = int(max(i[i >= 0].max() for i in ids_np if (i >= 0).any())) + 1
    part_of = np.full(n, -1, np.int64)
    local_of = np.zeros(n, np.int64)
    for p, ids in enumerate(ids_np):
        v = ids >= 0
        part_of[ids[v]] = p
        local_of[ids[v]] = np.nonzero(v)[0]
    part_of_t = torch.as_tensor(part_of).to(dev)
    local_of_t = torch.as_tensor(local_of).to(dev)
    ids_t = [torch.as_tensor(i.astype(np.int32)).to(dev) for i in ids_np]
    upds = [make_updater(part, max_moved, delta_width, device=dev)
            for part in chained.parts]
    cap = upds[0].cap

    def update(a, b, c, moved_idx) -> ChainedScene:
        a, b, c = _vertices(a, b, c, dev)
        moved = torch.as_tensor(moved_idx, device=dev).to(torch.int64)
        moved = moved.reshape(-1)
        if moved.shape[0] > cap:
            raise ValueError(
                f"{moved.shape[0]} moved ids > max_moved capacity {cap}")
        mvalid = moved >= 0
        safe_g = moved.clamp_min(0)
        out_parts, out_ids = [], []
        for p, (part, upd) in enumerate(zip(chained.parts, upds)):
            sel = ids_t[p]
            safe_sel = sel.clamp_min(0).to(torch.int64)
            moved_l = torch.where(mvalid & (part_of_t[safe_g] == p),
                                  local_of_t[safe_g], -1)
            masked_groups, outs, sl_s = upd.core(a[safe_sel], b[safe_sel],
                                                 c[safe_sel], moved_l)
            out_parts.append(part._replace(groups=masked_groups,
                                           bgroups=None, masked=True))
            out_ids.append(sel)
            for o, s in zip(outs, sl_s):
                out_parts.append(upd.delta_part(o))
                # part-local -> global
                out_ids.append(sel.clamp_min(0)[s.to(torch.int64)])
        return ChainedScene(parts=tuple(out_parts), orig_ids=tuple(out_ids))

    return update
