"""Scene builds and refits on the device: ``TightScene`` and
``ChainedScene`` tables made from vertex tensors, without a copy to the
host, for scenes whose geometry changes every frame.

Counterpart of ``bvh_tpu/ops/device_build.py`` (``_grid_layout``,
``_grid_wide_meta``, ``_grid_upper``, ``_build_core``, ``_grid_wide_ok``,
``build_tight_scene_device``, ``build_chained_scene_device`` and
``make_refitter``); the tables come out array-equal to the reference's,
NaN boxes in place. A build:

1. Morton-sorts the triangle centroids (one stable argsort),
2. cuts the order into clusters of ``width`` consecutive triangles,
3. builds the upper tree over the cluster boxes: the fixed 16-ary grid
   over the Morton-ordered clusters (``upper="grid"``; its shape is a host
   constant of the cluster count, so only the boxes are computed on the
   device, and it carries the group-walk table ``gnodes``), or a Karras
   LBVH (``upper="lbvh"``, ``bvh/lbvh.py``),
4. writes the entry/exit table and the cluster-relative triangle rows.

Empty columns of the grid (clusters past the live set, or nodes over only
empty ones) hold NaN boxes, which no slab or point-box test fires. The host
constants of a layout (``_grid_layout``, ``_grid_wide_meta``) are numpy,
cached per cluster count, and uploaded once per device. Every step is a
PyTorch operation; the reference computed these in XLA, not in a kernel,
so no CUDA kernel is needed here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bvh.lbvh import build_lbvh, morton_codes
from ..bvh.refit import interval_join, interval_rows
from ..device import resolve_device
from .cluster import (TIGHT, ChainedScene, TightScene, bilinear_blocks,
                      pack_bgroups)
from .trace import _dev

_INF = float("inf")
_THIRD = float(np.float32(1.0 / 3.0))  # the centroid's float32 factor
# the reference's scalar-memory budget of a table, an input here so that
# the port builds the reference's scenes (cluster.py)
_SMEM_BUDGET = 660_000
_LAYOUT_CACHE: dict = {}


def _np(x) -> np.ndarray:
    """A table as a numpy array (a tensor is copied to the host)."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _level_sizes(C: int, F: int) -> list[int]:
    """Node counts of the fixed-fanout levels over C clusters, leaves first,
    up to the root."""
    sizes = [C]
    while sizes[-1] > 1:
        sizes.append(-(-sizes[-1] // F))
    return sizes


def _grid_layout(C: int, F: int = 16):
    """Static DFS entry/exit layout of the fixed-fanout Morton hierarchy.

    Leaves are clusters 0..C-1 in Morton order; each level-k node spans F
    consecutive level-(k-1) nodes, up to a root. Returns numpy constants
    ``(sel, entry, exit, sizes)``: column t of the entry/exit table holds
    the node at row ``sel[t]`` of the level boxes stacked leaves first;
    entry and exit are final (leaf payloads -(cluster+1)). Cached per
    (C, F)."""
    key = (C, F)
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None:
        return hit
    sizes = _level_sizes(C, F)
    off = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    glevel, gidx, entry = [], [], []

    def emit(level, idx):
        t = len(glevel)
        glevel.append(level)
        gidx.append(idx)
        if level == 0:
            entry.append(-(idx + 1.0))
            return t
        entry.append(0.0)
        lo = idx * F
        first = None
        for j in range(lo, min(lo + F, sizes[level - 1])):
            ct = emit(level - 1, j)
            if first is None:
                first = ct
        entry[t] = float(first)
        return t

    emit(len(sizes) - 1, 0)
    # preorder DFS: exit[t] = t + the size of t's subtree
    sub = [np.ones(C, np.int64)]
    for k in range(1, len(sizes)):
        pad = np.zeros(sizes[k] * F, np.int64)
        pad[:sizes[k - 1]] = sub[-1]
        sub.append(1 + pad.reshape(sizes[k], F).sum(axis=1))
    glevel = np.asarray(glevel, np.int64)
    gidx = np.asarray(gidx, np.int64)
    subsize = np.concatenate(sub)[off[glevel] + gidx]
    out = ((off[glevel] + gidx).astype(np.int64),
           np.asarray(entry, np.float32),
           (np.arange(len(glevel)) + subsize).astype(np.float32),
           sizes)
    _LAYOUT_CACHE[key] = out
    return out


def _grid_wide_meta(C: int, F: int = 16):
    """Static group-walk topology of the fixed-fanout grid hierarchy, the
    device-build counterpart of ``cluster.build_wide_table``.

    The grid is already F-ary with a shape fixed by the cluster count, so
    the whole ``gnodes`` table but the boxes is a host constant: returns
    ``(template [7F+1, Gn] f32, box_sel [n_occ] i64, scat_idx [n_occ*6]
    i64, gslot [C] i32, depth)``. ``box_sel`` indexes the stacked level
    boxes (level-k node j at the level's offset + j); ``scat_idx`` holds
    the template's flat positions of each occupied slot's 6 box rows. Group
    0 is the root; children keep Morton (DFS) order. Cached per (C, F)."""
    key = ("wide", C, F)
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None:
        return hit
    sizes = _level_sizes(C, F)
    L = len(sizes)
    if L == 1:  # one cluster: one group whose only child is the cluster
        Gn = 8
        template = np.full((7 * F + 1, Gn), np.nan, np.float32)
        template[6:7 * F:7, :] = -1.0
        template[7 * F, :] = 0.0
        template[6, 0] = -1.0  # -(cluster 0 + 1)
        template[7 * F, 0] = 1.0  # leaf mask bit 0
        out = (template, np.zeros(1, np.int64), np.arange(6) * Gn,
               np.zeros(1, np.int32), 1)
        _LAYOUT_CACHE[key] = out
        return out
    # group levels 1..L-1, the root's first (gid 0), deeper levels after
    offs = np.zeros(L, np.int64)
    acc = 0
    for lvl in range(L - 1, 0, -1):
        offs[lvl] = acc
        acc += sizes[lvl]
    Gn = max(8, -(-acc // 8) * 8)
    template = np.full((7 * F + 1, Gn), np.nan, np.float32)
    template[6:7 * F:7, :] = -1.0  # empty-slot payload
    template[7 * F, :] = 0.0  # leaf masks
    level_off = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    sel_parts, scat_parts = [], []
    for lvl in range(1, L):
        ch = np.arange(sizes[lvl - 1], dtype=np.int64)
        g = offs[lvl] + ch // F
        k = ch % F
        if lvl == 1:
            template[7 * k + 6, g] = -(ch + 1.0)  # leaf payload
            np.add.at(template[7 * F], g, (1 << k).astype(np.float32))
        else:
            template[7 * k + 6, g] = (offs[lvl - 1] + ch).astype(np.float32)
        sel_parts.append(level_off[lvl - 1] + ch)
        rows6 = (7 * k)[:, None] + np.arange(6)[None, :]
        scat_parts.append((rows6 * Gn + g[:, None]).reshape(-1))
    gslot = ((offs[1] + np.arange(C) // F) * F
             + np.arange(C) % F).astype(np.int32)
    out = (template, np.concatenate(sel_parts), np.concatenate(scat_parts),
           gslot, L - 1)
    _LAYOUT_CACHE[key] = out
    return out


def _grid_wide_ok(C: int, F: int = 16) -> bool:
    """Whether a grid build carries the group-walk table: the reference's
    rule (a depth of at most 14 groups, and the table within its
    scalar-memory budget), from the level sizes alone."""
    sizes = _level_sizes(C, F)
    depth = max(len(sizes) - 1, 1)
    n_groups = max(sum(sizes[1:]), 1)
    Gn = max(8, -(-n_groups // 8) * 8)
    return depth <= 14 and (7 * F + 1) * Gn * 4 <= _SMEM_BUDGET


def _nan_empty(lo: torch.Tensor, hi: torch.Tensor):
    """Inverted boxes (no member) as NaN boxes, which never fire."""
    empty = (lo > hi).any(dim=1, keepdim=True)
    return (torch.where(empty, float("nan"), lo),
            torch.where(empty, float("nan"), hi))


def _grid_upper(cl_min: torch.Tensor, cl_max: torch.Tensor, fanout: int = 16,
                wide: bool = False):
    """Entry/exit table ``[8, Nn]`` of the fixed-fanout hierarchy over
    Morton-ordered cluster boxes; with ``wide``, also its group-walk table
    ``gnodes`` (the template of ``_grid_wide_meta`` with the boxes filled
    in): ``(smem_nodes, gnodes)``."""
    dev = cl_min.device
    C = cl_min.shape[0]
    sel, entry, exit_, sizes = _grid_layout(C, fanout)
    # level boxes, each level padded to a multiple of F with empty boxes
    mins, maxs = [cl_min], [cl_max]
    for k in range(1, len(sizes)):
        pm = torch.full((sizes[k] * fanout, 3), _INF, dtype=cl_min.dtype,
                        device=dev)
        px = torch.full((sizes[k] * fanout, 3), -_INF, dtype=cl_max.dtype,
                        device=dev)
        pm[:sizes[k - 1]] = mins[-1]
        px[:sizes[k - 1]] = maxs[-1]
        mins.append(pm.view(sizes[k], fanout, 3).amin(dim=1))
        maxs.append(px.view(sizes[k], fanout, 3).amax(dim=1))
    all_min = torch.cat(mins)
    all_max = torch.cat(maxs)
    sel_t = _dev(sel, dev)
    tmin, tmax = _nan_empty(all_min[sel_t], all_max[sel_t])
    smem_nodes = torch.cat([tmin.t(), tmax.t(), _dev(entry, dev)[None],
                            _dev(exit_, dev)[None]])
    if not wide:
        return smem_nodes
    template, box_sel, scat_idx, _, _ = _grid_wide_meta(C, fanout)
    bs = _dev(box_sel, dev)
    wmin, wmax = _nan_empty(all_min[bs], all_max[bs])
    gnodes = _dev(template, dev).reshape(-1).clone()
    gnodes[_dev(scat_idx, dev)] = torch.cat([wmin, wmax], dim=1).reshape(-1)
    return smem_nodes, gnodes.view(template.shape)


def _build_core(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                width: int = TIGHT, upper: str = "grid", bmat: bool = False,
                valid_in: torch.Tensor | None = None, wide: bool = False):
    """The tables of a device build: ``(smem_nodes, groups, tri_map, a_lo,
    bgroups, gnodes)`` on the vertices' device (``bgroups`` None without
    ``bmat``, ``gnodes`` None without ``wide``). ``a_lo`` is the scene's
    exact-frame table (``TightScene.a_lo``): a Morton cluster may span
    distant triangles, so its frame origin lies up to ~1e5 from them.

    ``valid_in``: optional [n] bool; triangles marked False are left out
    (they sort last, their lanes are degenerate and their ``tri_map``
    entries -1), so that a build can cover a run-time subset of a buffer
    of fixed size (the delta part of ``ops/update.py``). ``wide`` (grid
    only): also the group-walk table, last.
    """
    dev = a.device
    n = a.shape[0]
    W = width
    C = -(-n // W)
    n_pad = C * W
    G = -(-C // (128 // W))

    centroid = (a + b + c) * _THIRD
    if valid_in is None:
        lo = centroid.amin(dim=0)
        hi = centroid.amax(dim=0)
        codes = morton_codes(centroid, lo, hi)
    else:
        # left-out triangles touch neither the quantization bounds nor the
        # clusters (no valid triangle: bounds 0)
        any_v = valid_in.any()
        vi = valid_in[:, None]
        lo = torch.where(any_v, torch.where(vi, centroid, _INF).amin(dim=0),
                         0.0)
        hi = torch.where(any_v, torch.where(vi, centroid, -_INF).amax(dim=0),
                         0.0)
        codes = torch.where(valid_in, morton_codes(centroid, lo, hi),
                            0x7FFFFFFF)
    order = torch.argsort(codes, stable=True)
    order_p = torch.full((n_pad,), -1, dtype=torch.int64, device=dev)
    order_p[:n] = order
    valid = order_p >= 0
    if valid_in is not None:
        valid = valid & valid_in[order_p.clamp_min(0)]
        order_p = torch.where(valid, order_p, -1)
    safe = order_p.clamp_min(0)
    a_s, b_s, c_s = a[safe], b[safe], c[safe]

    # triangle boxes; padding lanes stay out of the cluster boxes
    v3 = valid[:, None]
    mn = torch.where(v3, torch.minimum(torch.minimum(a_s, b_s), c_s), _INF)
    mx = torch.where(v3, torch.maximum(torch.maximum(a_s, b_s), c_s), -_INF)
    cl_min = mn.view(C, W, 3).amin(dim=1)
    cl_max = mx.view(C, W, 3).amax(dim=1)
    cc = (cl_min + cl_max) * 0.5

    gnodes = None
    if upper == "grid":
        if wide:
            smem_nodes, gnodes = _grid_upper(cl_min, cl_max, wide=True)
        else:
            smem_nodes = _grid_upper(cl_min, cl_max)
    elif upper == "lbvh":
        flat, _ = build_lbvh(cl_min, cl_max)
        entry = torch.where(flat.entry < 0,
                            -(flat.shape.to(torch.float32) + 1.0),
                            flat.entry.to(torch.float32))
        smem_nodes = torch.cat([flat.aabb_min.t(), flat.aabb_max.t(),
                                entry[None],
                                flat.exit.to(torch.float32)[None]])
    else:
        raise ValueError(f"upper must be 'grid' or 'lbvh', got {upper!r}")

    # group rows: cluster-relative a', e1, e2 (padding lanes degenerate)
    ccl = cc.repeat_interleave(W, dim=0)
    av, a_lo = _rel_rows(a_s, ccl, v3)
    e1 = torch.where(v3, b_s - a_s, 0.0)
    e2 = torch.where(v3, c_s - a_s, 0.0)
    groups, a_lo = _group_rows(G, av, e1, e2, a_lo)
    tri_map = torch.full((G * 128,), -1, dtype=torch.int32, device=dev)
    tri_map[:n_pad] = order_p.to(torch.int32)
    bgroups = None
    if bmat:
        C_pad = G * (128 // W)
        pad_l = C_pad * W - n_pad
        if pad_l:
            z = torch.zeros((pad_l, 3), dtype=torch.float32, device=dev)
            av, e1, e2 = (torch.cat([x, z]) for x in (av, e1, e2))
        bgroups = pack_bgroups(bilinear_blocks(av, e1, e2), C_pad, W)
    return smem_nodes, groups, tri_map, a_lo, bgroups, gnodes


def _rel_rows(a_l: torch.Tensor, ccl: torch.Tensor, valid: torch.Tensor):
    """The rows ``a' = a - cc`` (float32) and their exact-frame remainder
    ``a_lo = (a - cc) - a'`` (computed in float64, rounded once to
    float32), 0 where ``valid`` [lanes, 1] is False."""
    av = torch.where(valid, a_l - ccl, 0.0)
    a_lo = (a_l.double() - ccl.double()) - av.double()
    return av, torch.where(valid, a_lo.float(), 0.0)


def _group_rows(G: int, av, e1, e2, a_lo):
    """``groups [G, 16, 128]`` from the lanes' rows a', e1, e2 and
    ``a_lo`` as [G, 3, 128] (lanes past the rows' end: 0)."""
    n = av.shape[0]
    rows = torch.zeros((G * 128, 16), dtype=torch.float32, device=av.device)
    rows[:n, 0:3] = av
    rows[:n, 3:6] = e1
    rows[:n, 6:9] = e2
    lo = torch.zeros((G * 128, 3), dtype=torch.float32, device=av.device)
    lo[:n] = a_lo
    return (rows.view(G, 128, 16).permute(0, 2, 1).contiguous(),
            lo.view(G, 128, 3).permute(0, 2, 1).contiguous())


def _vertices(a, b, c, dev):
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=dev)
                 for x in (a, b, c))


def _num_nodes(C: int, upper: str) -> int:
    if upper == "grid":
        return int(_grid_layout(C)[0].shape[0])
    return 2 * C - 1 if C > 1 else 1


def build_tight_scene_device(a, b, c, width: int = TIGHT, upper: str = "grid",
                             bmat: bool | None = None,
                             device=None) -> TightScene:
    """A ``TightScene`` built on the device from vertex arrays ``[n, 3]``
    (numpy or tensors): Morton clusters of ``width`` triangles under the
    fixed 16-ary grid (``upper="grid"``, the fastest build, with the
    group-walk table where the reference's rule allows it) or a Karras
    LBVH (``upper="lbvh"``). Every table is a tensor on ``device`` (None:
    the card); the scene plugs into ``trace_closest_hit_tight``,
    ``trace_any_hit_tight`` and ``nearest_tight``. Use the host
    ``build_tight_scene`` for static scenes (a better tree), this for a
    rebuild every frame. ``bmat`` also writes the bilinear forms
    ``bgroups`` (carried, not read by the port's walks; no group-walk
    table then, as in the reference)."""
    dev = resolve_device(device)
    a, b, c = _vertices(a, b, c, dev)
    n = a.shape[0]
    if n == 0:
        raise ValueError("empty scene")
    if width not in (16, 32, 64, 128):
        raise ValueError("width must be 16/32/64/128")
    bmat = bool(bmat)
    C = -(-n // width)
    wide = upper == "grid" and not bmat and _grid_wide_ok(C)
    smem_nodes, groups, tri_map, a_lo, bgroups, gnodes = _build_core(
        a, b, c, width, upper, bmat, wide=wide)
    gslot = None
    gdepth = 0
    if wide:
        _, _, _, gslot_np, gdepth = _grid_wide_meta(C)
        gslot = _dev(gslot_np, dev)
    return TightScene(smem_nodes, groups, tri_map, C, _num_nodes(C, upper),
                      width, bgroups, gnodes=gnodes, gslot=gslot,
                      gdepth=gdepth, a_lo=a_lo)


def build_chained_scene_device(a, b, c, max_part: int = 200_000,
                               width: int = TIGHT, upper: str = "grid",
                               device=None) -> ChainedScene:
    """A ``ChainedScene`` built on the device: one global Morton sort cuts
    the triangles into equal contiguous slices of at most ``max_part``,
    and each is built as ``build_tight_scene_device`` builds a scene, all
    with the same table shapes. Trace it with
    ``trace_closest_hit_chained`` and the other chained queries. A scene
    of one part is ``build_tight_scene_device``'s with ids 0..n-1."""
    dev = resolve_device(device)
    a, b, c = _vertices(a, b, c, dev)
    n = a.shape[0]
    if n == 0:
        raise ValueError("empty scene")
    P = -(-n // max_part)
    if P <= 1:
        scene = build_tight_scene_device(a, b, c, width=width, upper=upper,
                                         device=dev)
        return ChainedScene((scene,), (torch.arange(n, dtype=torch.int32,
                                                    device=dev),))
    sz = -(-n // P)
    centroid = (a + b + c) * _THIRD
    order = torch.argsort(morton_codes(centroid, centroid.amin(dim=0),
                                       centroid.amax(dim=0)), stable=True)
    order_p = torch.full((P * sz,), -1, dtype=torch.int32, device=dev)
    order_p[:n] = order.to(torch.int32)
    C = -(-sz // width)
    nn = _num_nodes(C, upper)
    wide = upper == "grid" and _grid_wide_ok(C)
    gslot, gdepth = None, 0
    if wide:
        _, _, _, gslot_np, gdepth = _grid_wide_meta(C)
        gslot = _dev(gslot_np, dev)
    parts, ids = [], []
    for p in range(P):
        sel = order_p[p * sz:(p + 1) * sz]
        safe = sel.clamp_min(0).to(torch.int64)
        sn, grp, tm, a_lo, _, gn = _build_core(a[safe], b[safe], c[safe],
                                               width, upper, False,
                                               valid_in=sel >= 0, wide=wide)
        parts.append(TightScene(sn, grp, tm, C, nn, width, gnodes=gn,
                                gslot=gslot, gdepth=gdepth, a_lo=a_lo))
        ids.append(sel)
    return ChainedScene(tuple(parts), tuple(ids))


def make_refitter(scene: TightScene, device=None):
    """``refit(a, b, c) -> TightScene``: the scene's topology and cluster
    assignment with the boxes and the triangle rows recomputed on the
    device from new vertex arrays.

    The per-frame path for deforming geometry: the group rows against the
    refit cluster-box centres, the cluster boxes, every upper node's box
    (the interval reduction of the leaf boxes over its DFS range
    ``[i, exit)``, from a sparse table) and the group-walk table's boxes
    (a segment reduction over each slot's range of leaves in DFS order).
    The tree stays consistent and tight after any deformation; its quality
    falls as the topology stops matching the geometry. The refit scene
    drops ``sweep_nodes`` (its boxes would be stale) and ``packed_nodes``
    (no device bf16 rounding), as the reference does; it keeps ``bgroups``
    in step where the scene has them. ``refit.core(a, b, c)`` returns the
    tables alone: ``(smem_nodes, groups, a_lo, bgroups, gnodes)``, None for
    a table the scene does not carry.

    Exact frame: the rows are re-encoded against the refit cluster
    centres; where churn drags a cluster's box (its members moved apart),
    the frame shift a - cc grows to ~1e5, where ``a'`` and ``o - cc``
    round at ~0.004 of a unit. The refit scene therefore carries ``a_lo``
    (``TightScene.a_lo``), and the walks test its leaves in the exact
    cluster frame.
    """
    dev = resolve_device(device)
    sn = _np(scene.smem_nodes)
    entry = sn[6]
    exit_ = sn[7].astype(np.int64)
    nn = entry.shape[0]  # the table's width, shape-bucket pad included
    nn_logical = int(scene.num_nodes)
    W = int(scene.width)
    C = int(scene.num_clusters)
    tm = _np(scene.tri_map)
    n_lanes = tm.shape[0]
    C_pad = n_lanes // W
    G = n_lanes // 128

    is_leaf = entry < 0
    leaf_cluster = np.where(is_leaf, (-entry - 1).astype(np.int64), 0)
    # sparse-table constants: column i covers [i, exit)
    kcol, flat_lo, flat_hi = interval_rows(torch.arange(nn),
                                           torch.from_numpy(exit_), nn)
    k_max = int(kcol.max())
    has_bmat = getattr(scene, "bgroups", None) is not None

    def t(x):
        return torch.as_tensor(np.asarray(x)).to(dev)

    # the group-walk table: each occupied slot's box is the reduction of
    # the refit cluster boxes over a contiguous range of leaves in DFS order
    has_wide = getattr(scene, "gnodes", None) is not None
    if has_wide:
        gn_np = _np(scene.gnodes)
        Kw = (gn_np.shape[0] - 1) // 7
        Gn = gn_np.shape[1]
        pay = gn_np[6:7 * Kw:7, :]
        gmask = gn_np[7 * Kw].astype(np.int64)
        leaf_slot = ((gmask[None, :] >> np.arange(Kw)[:, None]) & 1) > 0
        interior_slot = pay >= 0  # empty slots: payload -1, no leaf bit
        cl_of = np.where(leaf_slot, (-pay).astype(np.int64) - 1, 0)
        slot_lo = np.zeros((Kw, Gn), np.int64)
        slot_hi = np.zeros((Kw, Gn), np.int64)
        leaf_order: list[int] = []

        def walk(g: int) -> None:  # DFS over the group tree
            for k in range(Kw):
                if leaf_slot[k, g]:
                    slot_lo[k, g] = len(leaf_order)
                    leaf_order.append(int(cl_of[k, g]))
                    slot_hi[k, g] = len(leaf_order)
                elif interior_slot[k, g]:
                    slot_lo[k, g] = len(leaf_order)
                    walk(int(pay[k, g]))
                    slot_hi[k, g] = len(leaf_order)

        walk(0)
        if len(leaf_order) != len(set(leaf_order)):
            raise ValueError("the group tree holds a cluster twice")
        occ = leaf_slot | interior_slot
        kseg, gseg_lo, gseg_hi = interval_rows(
            torch.from_numpy(slot_lo[occ]), torch.from_numpy(slot_hi[occ]),
            len(leaf_order))
        kseg_max = int(kseg.max())
        gseg_lo, gseg_hi = t(gseg_lo), t(gseg_hi)
        kk, gg = np.nonzero(occ)
        rows6 = (7 * kk)[:, None] + np.arange(6)[None, :]
        scat_idx = t((rows6 * Gn + gg[:, None]).reshape(-1))
        leaf_order_t = t(np.asarray(leaf_order, np.int64))
        gn_flat = t(gn_np.reshape(-1))

    tri_map = t(tm)
    leaf_cluster_t = t(leaf_cluster)
    is_leaf_t = t(is_leaf)
    flat_lo_t, flat_hi_t = t(flat_lo), t(flat_hi)
    valid_t = t(tm >= 0)[:, None]
    safe_t = t(np.maximum(tm, 0).astype(np.int64))
    entry_t = t(entry)
    exit_t = t(sn[7])
    pad_col = t(np.arange(nn) >= nn_logical)[:, None]
    pad_min, pad_max = t(sn[0:3].T), t(sn[3:6].T)
    def refit_core(a, b, c):
        a, b, c = _vertices(a, b, c, dev)
        a_l, b_l, c_l = a[safe_t], b[safe_t], c[safe_t]
        mn = torch.where(valid_t, torch.minimum(torch.minimum(a_l, b_l), c_l),
                         _INF)
        mx = torch.where(valid_t, torch.maximum(torch.maximum(a_l, b_l), c_l),
                         -_INF)
        cl_min = mn.view(C_pad, W, 3).amin(dim=1)
        cl_max = mx.view(C_pad, W, 3).amax(dim=1)
        cc = (cl_min + cl_max) * 0.5

        # group rows, cluster-relative to the refit centres
        ccl = cc.repeat_interleave(W, dim=0)
        av, a_lo = _rel_rows(a_l, ccl, valid_t)
        e1 = torch.where(valid_t, b_l - a_l, 0.0)
        e2 = torch.where(valid_t, c_l - a_l, 0.0)
        groups, a_lo = _group_rows(G, av, e1, e2, a_lo)

        # upper boxes: a leaf takes its cluster's box, an internal node the
        # reduction over its DFS interval
        lmin0 = torch.where(is_leaf_t[:, None], cl_min[leaf_cluster_t], _INF)
        lmax0 = torch.where(is_leaf_t[:, None], cl_max[leaf_cluster_t], -_INF)
        tmin, tmax = interval_join(lmin0, lmax0, k_max, flat_lo_t, flat_hi_t)
        if nn > nn_logical:
            # shape-bucket pad columns stay as they were (their intervals
            # hold no leaf, so the reduction would invert them)
            tmin = torch.where(pad_col, pad_min, tmin)
            tmax = torch.where(pad_col, pad_max, tmax)
        smem_nodes = torch.cat([tmin.t(), tmax.t(), entry_t[None],
                                exit_t[None]])
        bgroups = gnodes = None
        if has_bmat:
            bgroups = pack_bgroups(bilinear_blocks(av, e1, e2), C_pad, W)
        if has_wide:
            smin, smax = interval_join(cl_min[leaf_order_t],
                                       cl_max[leaf_order_t], kseg_max,
                                       gseg_lo, gseg_hi)
            gn = gn_flat.clone()
            gn[scat_idx] = torch.cat([smin, smax], dim=1).reshape(-1)
            gnodes = gn.view(gn_np.shape)
        return smem_nodes, groups, a_lo, bgroups, gnodes

    def refit(a, b, c) -> TightScene:
        smem_nodes, groups, a_lo, bgroups, gnodes = refit_core(a, b, c)
        return TightScene(smem_nodes, groups, tri_map, C, nn_logical, W,
                          bgroups, gnodes=gnodes,
                          gslot=scene.gslot if has_wide else None,
                          gdepth=int(scene.gdepth) if has_wide else 0,
                          a_lo=a_lo)

    refit.core = refit_core
    return refit
