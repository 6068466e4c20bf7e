"""Nearest-triangle queries over a ``TightScene``: the point sort, the point
prologue, the two walks (kernel wrappers, launch counts and plain PyTorch
versions) and the entry point ``nearest_tight``.

Counterpart of ``bvh_tpu/ops/nearest.py``. The CUDA kernels
(``csrc/nearest.cu``) replace the TPU kernels ``_nearest_wide_body`` (the
group walk over ``gnodes``) and ``_nearest_body`` (the entry/exit walk over
``smem_nodes``) with their shared narrowphase ``_point_narrow``. Both walks
run a warp of 32 points together (one group or node order for the warp,
each fired leaf narrowphased by the lanes that fired it together); the
plain versions below compute the same function, point by point, in lock
step over a batch, and round every operation as the kernels do, so the two
agree bit for bit on the card. See
the kernel source for the walks' rules; the two walks order the bound
refinement differently (the group walk fires against ``vb`` as read before
the group, the entry/exit walk refines first), and each keeps its own
order.

The bound seed (``nearest_seed``, a kernel of its own, and
``nearest_seed_plain``) runs before either walk where the scene has the
wide table and is not masked: a greedy descent from the root, into the
child of least box distance, folds the least farthest-corner distance d2max
of every child it tested, one ulp up, into the point's radius row. Every
box holds a triangle within its d2max, so the leaf of the nearest triangle,
whose box lies within d*^2 of the point, still fires; the ulp keeps firing
the leaf the descent ended in, whose two distances may round to one value.
Unseeded, the group walk enters fired children lowest slot first and
tightens its bound only through the groups it enters, so on sparse scenes
it narrowphases many far leaves before it reaches the nearest one. The
walks themselves are unchanged: a seeded call is the seed, then the walk on
the seeded rows.

Inputs: the tables ``gnodes [113, Gn]`` or ``smem_nodes [8, Nn]`` and
``groups [G, 16, 128]`` float32 (see ``ops/cluster.py``), and the point
rows ``pts [4, n]`` float32: x, y, z and d_max² (+inf without a radius).
The TPU kernels' slab and point-matrix layouts (``_pack_points``) are not
copied: a warp's points need no packet padding.
Output per point: ``d2`` float32 (the packed key's bits with the lane bits
cleared, so up to W-1 ulps below the nearest squared distance; +inf where
nothing lies within the radius) and ``lane_id`` int32 (cluster·W + lane,
-1 where there is none).

The narrowphase takes d1 = e1·q and d2 = e2·q with q = p' − a' directly,
where the TPU kernel forms e1·p' − e1·a' through a matrix product; the
port differs from the reference at rounding level.

Scenes that carry the exact-frame table ``a_lo`` (every scene the port
builds or loads; a device build's clusters may lie ~1e5 from their frame
origin) run the kernels' FRAME builds: q = ((p' − a') + lo) − a_lo, with lo
the rounding error of p − cc (``wide.two_diff``), as the trace walks test
their leaves. The reference rounds p − cc, so on far frames the port takes
float64 brute force's triangle where the reference may take a farther one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import obs
from ..bvh.lbvh import morton_codes
from ..device import resolve_device
from ._build import load_cuda_library
from .trace import (_a_lo, _chain_ids, _check_packet, _dev, _order, _take,
                    _unsort, packet_sums)
from .wide import (K, SENT, WIDE_DMAX, check_a_lo, check_depth, count_outputs,
                   decode_keys, dfs_walk, fired_leaves, fold_slots, two_diff)

_INF = float("inf")
N_ROWS = 4  # point rows: x, y, z, d_max^2

# float32 operations, counted from csrc/nearest.cu:
# per box test, d2min: 6 sub, 6 max, 3 mul, 2 add, 1 compare;
BOX_OPS = 18
# the refinement's d2max: 6 sub, 3 max, 3 mul, 2 add (the group walk adds
# a NaN test; both add the min);
D2MAX_OPS = 14
# per (point, triangle) pair, whatever its region: q 3, d1 and d2 10,
# d3..d6 4, the vertex-A test 2, f = v e1 + w e2 − q 12, d² 5, the key 5
# (the other regions' tests and divisions add up to 24; the group walk's
# kernel evaluates every region test, and a division where a lane of the
# warp needs it);
PAIR_OPS = 41
# per triangle, whatever the number of points tested against it: |e1|²,
# e1·e2 and |e2|² (a bound charges them once for every triangle of the
# scene);
TRI_ONCE_OPS = 15
# per fired leaf: the frame centre 6, p' 3, the bound update 2;
LEAF_OPS = 11
# per entry/exit node visit beyond its box test: the leaf test and the
# cursor select.
STEP_OPS = 2

# the seed's operations a group test beyond the walk's box tests: per child
# the NaN test, the bound's min and the two compares of its choice.
SEED_OPS = 4

# the FRAME builds' extra operations: per (point, triangle) pair the add
# of lo and the subtract of a_lo an axis (beside three loads of a_lo);
FRAME_PAIR_OPS = 6
# per fired leaf, lo: two_diff's five operations an axis beyond p'.
FRAME_LEAF_OPS = 15


def walk_ops(wide: bool, width: int, steps: float, fires: float,
             frame: bool = False) -> float:
    """float32 operations of one point's walk with the bound refinement:
    ``steps`` group tests (wide) or node visits (entry/exit) and ``fires``
    narrowphased leaves; ``frame``: the FRAME builds' leaf tests."""
    if wide:
        step = K * (BOX_OPS + D2MAX_OPS + 2)
    else:
        step = BOX_OPS + STEP_OPS + D2MAX_OPS + 1
    leaf = LEAF_OPS + width * PAIR_OPS
    if frame:
        leaf += FRAME_LEAF_OPS + width * FRAME_PAIR_OPS
    return steps * step + fires * leaf


def seed_ops(steps: float) -> float:
    """float32 operations of one point's bound seed over ``steps`` group
    tests."""
    return steps * K * (BOX_OPS + D2MAX_OPS + SEED_OPS)


@functools.cache
def load() -> ctypes.CDLL:
    """Builds (first call) and loads ``csrc/nearest.cu``."""
    return bind(load_cuda_library("nearest", "nearest.cu"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a build of ``nearest.cu``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.nearest_wide_launch, lib.nearest_entry_exit_launch):
        fn.restype = ci
        fn.argtypes = [vp, ci, vp, ci, ci, vp, ci, vp, vp, vp, vp, vp, vp]
    lib.nearest_seed_launch.restype = ci
    lib.nearest_seed_launch.argtypes = [vp, ci, vp, ci, vp, vp]
    return lib


def _check(name: str, table, rows: int, groups, pts, width: int,
           a_lo) -> None:
    for nm, x in ((name, table), ("groups", groups), ("pts", pts)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{nm} must be a contiguous float32 tensor")
        if x.device != pts.device:
            raise ValueError(f"{nm} is on {x.device}, pts on {pts.device}")
    if table.dim() != 2 or table.shape[0] != rows:
        raise ValueError(f"{name} must be [{rows}, N], got {tuple(table.shape)}")
    if groups.dim() != 3 or tuple(groups.shape[1:]) != (16, 128):
        raise ValueError(f"groups must be [G, 16, 128], got {tuple(groups.shape)}")
    if pts.dim() != 2 or pts.shape[0] != N_ROWS:
        raise ValueError(f"pts must be [{N_ROWS}, n], got {tuple(pts.shape)}")
    if width not in (16, 32, 64, 128):
        raise ValueError(f"width must be 16/32/64/128, got {width}")
    check_a_lo(a_lo, groups, pts)


def _launch(fn, table, groups, pts, width: int, refine: bool,
            counts: bool = False, a_lo: torch.Tensor | None = None):
    n = pts.shape[1]
    d2 = torch.empty(n, dtype=torch.float32, device=pts.device)
    lane_id = torch.empty(n, dtype=torch.int32, device=pts.device)
    steps, fires = count_outputs(n, pts.device, counts)
    rc = fn(table.data_ptr(), table.shape[1], groups.data_ptr(), width,
            int(refine), pts.data_ptr(), n, d2.data_ptr(), lane_id.data_ptr(),
            0 if steps is None else steps.data_ptr(),
            0 if fires is None else fires.data_ptr(),
            0 if a_lo is None else a_lo.data_ptr(),
            torch.cuda.current_stream(pts.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nearest kernel launch failed: CUDA error {rc}")
    if counts:
        return d2, lane_id, steps.to(torch.int64), fires.to(torch.int64)
    return d2, lane_id


def nearest_wide(gnodes: torch.Tensor, groups: torch.Tensor, pts: torch.Tensor,
                 width: int, depth: int, refine: bool = True,
                 counts: bool = False, a_lo: torch.Tensor | None = None):
    """Nearest triangle of every point by the group walk: ``(d2, lane_id)``;
    with ``counts``, ``(d2, lane_id, group_tests, leaf_fires)``, each
    point's own walk's (int64), as ``nearest_wide_plain(counts=True)``
    gives them.

    ``depth`` is the wide tree's group depth (``TightScene.gdepth``).
    ``refine``: tighten the bound with the boxes' farthest corners (off for
    masked scenes, whose boxes may hold no live triangle). ``a_lo``: the
    scene's exact-frame table [G, 3, 128] (``TightScene.a_lo``), with which
    the leaf tests take the exact cluster frame (the FRAME build).

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the kernel: with ``counts`` its counting build (a debug build,
    not a timed one; its results are the timed build's bit for bit).
    """
    _check("gnodes", gnodes, 7 * K + 1, groups, pts, width, a_lo)
    check_depth(depth)
    if pts.device.type == "cpu":
        return nearest_wide_plain(gnodes, groups, pts, width, refine=refine,
                                  counts=counts, a_lo=a_lo)
    if pts.device.type != "cuda":
        raise ValueError(f"no nearest_wide kernel for device {pts.device}")
    out = _launch(load().nearest_wide_launch, gnodes, groups, pts, width,
                  refine, counts, a_lo)
    if counts:
        obs.count("launch.nearest_wide_count")
    else:
        obs.launch("nearest_wide", frame=a_lo is not None)
    return out


def nearest_entry_exit(smem_nodes: torch.Tensor, groups: torch.Tensor,
                       pts: torch.Tensor, width: int, refine: bool = True,
                       counts: bool = False,
                       a_lo: torch.Tensor | None = None):
    """Nearest triangle of every point by the entry/exit walk over
    ``smem_nodes [8, Nn]``: ``(d2, lane_id)``, as ``nearest_wide``; with
    ``counts`` also each point's node visits and leaf fires; ``a_lo`` as
    in ``nearest_wide`` (the FRAME build).

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the kernel (with ``counts``, its counting build).
    """
    _check("smem_nodes", smem_nodes, 8, groups, pts, width, a_lo)
    if pts.device.type == "cpu":
        return nearest_entry_exit_plain(smem_nodes, groups, pts, width,
                                        refine=refine, counts=counts,
                                        a_lo=a_lo)
    if pts.device.type != "cuda":
        raise ValueError(f"no nearest_entry_exit kernel for device {pts.device}")
    out = _launch(load().nearest_entry_exit_launch, smem_nodes, groups, pts,
                  width, refine, counts, a_lo)
    if counts:
        obs.count("launch.nearest_entry_exit_count")
    else:
        obs.launch("nearest_entry_exit", frame=a_lo is not None)
    return out


def nearest_seed(gnodes: torch.Tensor, rows: torch.Tensor,
                 counts: bool = False):
    """Seeds the walks' bound in place: ``rows[3] = min(rows[3], seed)``,
    with ``seed`` one ulp above the least farthest-corner distance d2max of
    every child a greedy descent from the root tests (the walk's box tests;
    at each group it moves into the child of least d2min, ties to the least
    d2max, and stops at a leaf child or a group with no child to take).
    Returns None; with ``counts``, each point's group tests (int64).

    Every box holds a triangle within its d2max, so the bound keeps every
    leaf that can hold the answer; a masked scene's boxes may hold none, so
    it takes no seed. On a CPU tensor this runs the plain version; on a
    CUDA tensor it launches the kernel (its group tests written where
    ``counts``).
    """
    for nm, x in (("gnodes", gnodes), ("pts", rows)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{nm} must be a contiguous float32 tensor")
    if gnodes.device != rows.device:
        raise ValueError(f"gnodes is on {gnodes.device}, pts on {rows.device}")
    if gnodes.dim() != 2 or gnodes.shape[0] != 7 * K + 1:
        raise ValueError(f"gnodes must be [{7 * K + 1}, N], got "
                         f"{tuple(gnodes.shape)}")
    if rows.dim() != 2 or rows.shape[0] != N_ROWS:
        raise ValueError(f"pts must be [{N_ROWS}, n], got {tuple(rows.shape)}")
    if rows.device.type == "cpu":
        return nearest_seed_plain(gnodes, rows, counts=counts)
    if rows.device.type != "cuda":
        raise ValueError(f"no nearest_seed kernel for device {rows.device}")
    n = rows.shape[1]
    steps = (torch.empty(n, dtype=torch.int32, device=rows.device)
             if counts else None)
    rc = load().nearest_seed_launch(
        gnodes.data_ptr(), gnodes.shape[1], rows.data_ptr(), n,
        0 if steps is None else steps.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nearest seed launch failed: CUDA error {rc}")
    if counts:
        obs.count("launch.nearest_seed_count")
        return steps.to(torch.int64)
    obs.launch("nearest_seed")
    return None


def nearest_seed_plain(gnodes: torch.Tensor, rows: torch.Tensor,
                       counts: bool = False):
    """The seed kernel's function in plain PyTorch (any device), in place on
    ``rows[3]``: None, or with ``counts`` each point's group tests (int64).
    """
    dev = rows.device
    n = rows.shape[1]
    Gn = gnodes.shape[1]
    box = gnodes[:7 * K].view(K, 7, Gn)
    lmask_all = gnodes[7 * K].to(torch.int32)
    seed = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    slots = torch.arange(K, device=dev)[:, None]
    live = torch.arange(n if Gn > 0 else 0, device=dev)
    g = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(WIDE_DMAX):
        if not live.numel():
            break
        gl = g[live]
        bx6 = box[:, 0:6, gl].unbind(1)  # 6 x [K, m]
        p3 = (rows[0, live], rows[1, live], rows[2, live])
        d2max = _d2max(*p3, *bx6)
        d2max = torch.where(d2max == d2max, d2max, _INF)
        seed[live] = torch.minimum(seed[live], d2max.amin(dim=0))
        d2min = _d2min(*p3, *bx6)
        # the least (d2min, d2max), the lowest slot of equals; a NaN or
        # +inf d2min is never taken
        ok = d2min < _INF
        m1 = torch.where(ok, d2min, _INF).amin(dim=0)
        cand = ok & (d2min == m1)
        m2 = torch.where(cand, d2max, _INF).amin(dim=0)
        k = torch.where(cand & (d2max == m2), slots, K).amin(dim=0)
        tests[live] += 1
        leaf = ((lmask_all[gl] >> k.clamp(max=K - 1)) & 1) == 1
        down = ok.any(dim=0) & ~leaf
        g[live[down]] = box[k[down], 6, gl[down]].to(torch.int64)
        live = live[down]
    bumped = torch.where(seed < _INF, torch.nextafter(
        seed, torch.full((), _INF, device=dev)), seed)
    rows[3] = torch.minimum(rows[3], bumped)
    return tests if counts else None


def _seeds(scene) -> bool:
    """Whether the walks over ``scene`` start from the bound seed: where the
    scene has the wide table and is not masked."""
    return scene.gnodes is not None and not scene.masked


def _d2min(px, py, pz, ax, ay, az, bx, by, bz):
    zero = torch.zeros((), dtype=torch.float32, device=px.device)
    tx = torch.maximum(torch.maximum(ax - px, px - bx), zero)
    ty = torch.maximum(torch.maximum(ay - py, py - by), zero)
    tz = torch.maximum(torch.maximum(az - pz, pz - bz), zero)
    return (tx * tx + ty * ty) + tz * tz


def _d2max(px, py, pz, ax, ay, az, bx, by, bz):
    mx = torch.maximum(px - ax, bx - px)
    my = torch.maximum(py - ay, by - py)
    mz = torch.maximum(pz - az, bz - pz)
    return (mx * mx + my * my) + mz * mz


def _narrow_plain(pts, tiles, W: int, r, c, ccx, ccy, ccz,
                  a_lo=None) -> torch.Tensor:
    """Narrowphase of the (point r[i], cluster c[i]) pairs with frame
    origins cc: each pair's smallest packed key over the cluster's W
    triangles. ``tiles [G, 128, 9]``: rows a', e1, e2 lane-major.
    ``a_lo`` [G, 3, 128]: the exact cluster frame (the FRAME builds'), q =
    ((p' - a') + lo) - a_lo with lo the rounding error of p - cc."""
    lanes = torch.arange(W, dtype=torch.int32, device=pts.device)
    per_row = 128 // W
    lane = (c % per_row)[:, None] * W + lanes[None, :]
    tri = tiles[(c // per_row)[:, None], lane]  # [P, W, 9]
    a0, a1, a2, e10, e11, e12, e20, e21, e22 = tri.unbind(-1)
    # the point in the cluster frame, then relative to a'
    qx = (pts[0, r] - ccx)[:, None] - a0
    qy = (pts[1, r] - ccy)[:, None] - a1
    qz = (pts[2, r] - ccz)[:, None] - a2
    if a_lo is not None:
        lox, loy, loz = (two_diff(pts[j, r], cc)[1][:, None]
                         for j, cc in enumerate((ccx, ccy, ccz)))
        al = a_lo.permute(0, 2, 1)[(c // per_row)[:, None], lane]  # [P, W, 3]
        qx = (qx + lox) - al[..., 0]
        qy = (qy + loy) - al[..., 1]
        qz = (qz + loz) - al[..., 2]
    d1 = (e10 * qx + e11 * qy) + e12 * qz
    d2 = (e20 * qx + e21 * qy) + e22 * qz
    aa = (e10 * e10 + e11 * e11) + e12 * e12
    bc = (e10 * e20 + e11 * e21) + e12 * e22
    cc = (e20 * e20 + e21 * e21) + e22 * e22
    d3, d4, d5, d6 = d1 - aa, d2 - bc, d1 - bc, d2 - cc
    vc = d1 * d4 - d3 * d2
    vb2 = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    # every region's candidate, selected in reverse priority (A > B > AB >
    # C > AC > BC > face) so that the earliest region wins; the chosen one
    # is the kernel's expression
    denom = (va + vb2) + vc
    v, w = vb2 / denom, vc / denom
    t_bc = (d4 - d3) / ((d4 - d3) + (d5 - d6))
    r_bc = (va <= 0.0) & (d4 - d3 >= 0.0) & (d5 - d6 >= 0.0)
    v, w = torch.where(r_bc, 1.0 - t_bc, v), torch.where(r_bc, t_bc, w)
    r_ac = (vb2 <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    v, w = torch.where(r_ac, 0.0, v), torch.where(r_ac, d2 / (d2 - d6), w)
    r_c = (d6 >= 0.0) & (d5 <= d6)
    v, w = torch.where(r_c, 0.0, v), torch.where(r_c, 1.0, w)
    r_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    v, w = torch.where(r_ab, d1 / (d1 - d3), v), torch.where(r_ab, 0.0, w)
    r_b = (d3 >= 0.0) & (d4 <= d3)
    v, w = torch.where(r_b, 1.0, v), torch.where(r_b, 0.0, w)
    r_a = (d1 <= 0.0) & (d2 <= 0.0)
    v, w = torch.where(r_a, 0.0, v), torch.where(r_a, 0.0, w)
    fx = (v * e10 + w * e20) - qx
    fy = (v * e11 + w * e21) - qy
    fz = (v * e12 + w * e22) - qz
    dd = (fx * fx + fy * fy) + fz * fz
    ok = (aa > 0.0) & (dd < _INF)
    key = torch.where(ok, (dd.view(torch.int32) & -W) | lanes[None, :],
                      torch.full((), SENT, dtype=torch.int32, device=pts.device))
    return key.amin(dim=1)


def _tiles(groups: torch.Tensor) -> torch.Tensor:
    """``groups [G, 16, 128]`` as lane-major rows a', e1, e2: [G, 128, 9]."""
    return groups[:, :9].permute(0, 2, 1).contiguous()


def nearest_wide_plain(gnodes: torch.Tensor, groups: torch.Tensor,
                       pts: torch.Tensor, width: int, refine: bool = True,
                       counts: bool = False,
                       a_lo: torch.Tensor | None = None):
    """The group-walk kernel's function in plain PyTorch (any device).

    Returns ``(d2, lane_id)``, or with ``counts=True``
    ``(d2, lane_id, group_tests, leaf_fires)``: per point, the groups whose
    16 children it tested and the leaf clusters it narrowphased (int64).
    ``a_lo`` as in ``nearest_wide``.
    """
    W = width
    dev = pts.device
    n = pts.shape[1]
    Gn = gnodes.shape[1]
    box = gnodes[:7 * K].view(K, 7, Gn)
    pay_all = box[:, 6]  # [K, Gn]
    lmask_all = gnodes[7 * K].to(torch.int32)  # [Gn]
    tiles = _tiles(groups)

    bk = torch.full((n,), SENT, dtype=torch.int32, device=dev)
    bc = torch.zeros(n, dtype=torch.int32, device=dev)
    vb = pts[3].clone()
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    fires = torch.zeros(n, dtype=torch.int64, device=dev)

    def enter(r, g):
        """Tests groups g (one per point r): the fired mask against vb as
        read before the group, then the bound refinement; narrowphases the
        fired leaves and returns the fired interior bits."""
        bx6 = box[:, 0:6, g].unbind(1)  # 6 x [K, m]
        p3 = (pts[0, r], pts[1, r], pts[2, r])
        vbv = vb[r]
        fired = _d2min(*p3, *bx6) < vbv
        if refine:
            d2max = _d2max(*p3, *bx6)
            d2max = torch.where(d2max == d2max, d2max, _INF)
            vb[r] = torch.minimum(vbv, d2max.amin(dim=0))
        lmask = lmask_all[g]
        m, kk, ii = fired_leaves(fired, lmask)
        if counts:
            tests[r] += 1
            fires.index_add_(0, r[ii], torch.ones_like(ii))
        if kk.numel():
            gg = g[ii]
            c = (-pay_all[kk, gg] - 1.0).to(torch.int64)
            ax, ay, az, bx, by, bz = (box[kk, j, gg] for j in range(6))
            km = _narrow_plain(pts, tiles, W, r[ii], c, (ax + bx) * 0.5,
                               (ay + by) * 0.5, (az + bz) * 0.5, a_lo)
            fold_slots(r, ii, kk, km, c.to(torch.int32), bk, bc, vb, W,
                       bounded=True)
        return m & ~lmask

    dfs_walk(torch.arange(n, device=dev), enter, pay_all, n)
    d2, lane_id = decode_keys(bk, bc, W)
    if counts:
        return d2, lane_id, tests, fires
    return d2, lane_id


def nearest_entry_exit_plain(smem_nodes: torch.Tensor, groups: torch.Tensor,
                             pts: torch.Tensor, width: int,
                             refine: bool = True, counts: bool = False,
                             a_lo: torch.Tensor | None = None):
    """The entry/exit kernel's function in plain PyTorch (any device).

    Returns ``(d2, lane_id)``, or with ``counts=True``
    ``(d2, lane_id, node_visits, leaf_fires)`` per point (int64). ``a_lo``
    as in ``nearest_wide``.
    """
    W = width
    dev = pts.device
    n = pts.shape[1]
    nn = smem_nodes.shape[1]
    tiles = _tiles(groups)

    bk = torch.full((n,), SENT, dtype=torch.int32, device=dev)
    bc = torch.zeros(n, dtype=torch.int32, device=dev)
    vb = pts[3].clone()
    visits = torch.zeros(n, dtype=torch.int64, device=dev)
    fires = torch.zeros(n, dtype=torch.int64, device=dev)

    cursor = torch.zeros(n, dtype=torch.int64, device=dev)
    live = torch.arange(n if nn > 0 else 0, device=dev)
    while live.numel():
        ax, ay, az, bx, by, bz, entry, exit_ = smem_nodes[:, cursor[live]].unbind(0)
        p3 = (pts[0, live], pts[1, live], pts[2, live])
        box = (ax, ay, az, bx, by, bz)
        d2min = _d2min(*p3, *box)
        if refine:
            vb[live] = torch.minimum(vb[live], _d2max(*p3, *box))
        fired = d2min < vb[live]
        leaf = entry < 0.0
        narrow = fired & leaf
        r = live[narrow]
        if counts:
            visits[live] += 1
            fires[r] += 1
        if r.numel():
            c = (-entry[narrow] - 1.0).to(torch.int64)
            km = _narrow_plain(pts, tiles, W, r, c,
                               (ax[narrow] + bx[narrow]) * 0.5,
                               (ay[narrow] + by[narrow]) * 0.5,
                               (az[narrow] + bz[narrow]) * 0.5, a_lo)
            old = bk[r]
            closer = km < old
            nbk = torch.where(closer, km, old)
            bk[r] = nbk
            bc[r] = torch.where(closer, c.to(torch.int32), bc[r])
            vb[r] = torch.minimum((nbk & -W).view(torch.float32), vb[r])
        nxt = torch.where(leaf | ~fired, exit_, entry).to(torch.int64)
        cursor[live] = nxt
        live = live[nxt < nn]

    d2, lane_id = decode_keys(bk, bc, W)
    if counts:
        return d2, lane_id, visits, fires
    return d2, lane_id


def sort_points_device(points, device=None):
    """Morton coherence sort of a point batch on the device: ``(perm, inv)``
    int64 (``perm`` sorts, ``inv`` un-sorts).

    Keys are 30-bit Morton codes over the points' own bounds; the argsort
    is stable. Neighbouring threads then walk similar subtrees. Per-point
    results do not depend on the order.
    """
    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    if pts.shape[0] == 0:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        return e, e
    return _order(morton_codes(pts, pts.amin(dim=0), pts.amax(dim=0)))


def point_rows(pts: torch.Tensor, d_max: torch.Tensor | None) -> torch.Tensor:
    """The kernels' point rows [4, n]: x, y, z and d_max² (+inf when
    ``d_max`` is None)."""
    bound2 = (torch.full((pts.shape[0],), _INF, dtype=torch.float32,
                         device=pts.device)
              if d_max is None else d_max * d_max)
    return torch.stack([pts[:, 0], pts[:, 1], pts[:, 2], bound2])


def nearest_tight(scene, points, packet: int = 2048, d_max=None,
                  wide: bool | None = None, sort: bool = True, device=None):
    """Nearest triangle to each point: ``(shape_id [n] int32, distance [n]
    float32)``, the reference's ``nearest_to`` with an optional radius.

    ``shape_id`` is the global id of the nearest triangle and ``distance``
    the square root of the kernel's squared distance. ``shape_id`` is -1
    (distance +inf) only when ``d_max`` is given and no triangle lies
    within it, or the scene is empty.

    ``d_max``: optional scalar or [n] search radius; triangles at distance
    >= d_max are ignored, and the radius prunes the walk from the start.
    ``wide``: None takes the group walk exactly when the scene carries
    ``gnodes``; False takes the entry/exit walk; the two give identical
    distances, and the same triangles but where two lie at exactly the
    same distance (the walks order their leaves differently). ``sort``:
    Morton-sort batches of more than 128 points on the device first
    (results come back in input order and do not depend on it). ``packet`` is validated (a power of two >= 128) and kept for call
    compatibility with the reference; it does not change the per-point
    walk. ``device``: where to run (None: the card).

    Before either walk, on a scene that carries ``gnodes`` and is not
    masked, ``nearest_seed`` folds a bound into each point's row: the least
    farthest-corner distance over the children a greedy descent from the
    root tests, one ulp up. Each of those boxes holds a triangle within
    that distance, so the leaf of the nearest triangle keeps d2min <= d*^2
    <= the bound and still fires, and the walk, which would otherwise
    tighten its bound only through the groups it happens to enter first,
    skips most far subtrees. Distances are the unseeded walk's; a triangle
    may differ only where two lie at the same distance, as between the two
    walks. Masked scenes (the static part of an updater) turn off the bound
    refinement and take no seed (counted in ``nearest.unseeded``): their
    boxes may hold no live triangle. Packed scenes raise.
    Scenes that carry ``a_lo`` (every scene the port builds or loads) test
    their leaves in the exact cluster frame (the kernels' FRAME builds).

    A call is one ``obs`` span ``nearest`` with four stages: ``sort`` (the
    Morton sort and the points' gather), ``prologue`` (the point rows),
    ``walk`` (the seed's and the walk's launches) and ``epilogue`` (the
    radius mask, the triangle ids, the float64 root and the un-permute).
    """
    _check_packet(packet)
    with obs.span("nearest"):
        dev = resolve_device(device)
        pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
        pts = pts.reshape(-1, 3)
        r = pts.shape[0]
        if r == 0 or scene.num_nodes == 0:
            return (torch.full((r,), -1, dtype=torch.int32, device=dev),
                    torch.full((r,), _INF, dtype=torch.float32, device=dev))
        dm = None
        if d_max is not None:
            dm = torch.as_tensor(d_max, dtype=torch.float32, device=dev)
            dm = dm.reshape(-1).expand(r)
        with obs.span("sort"):
            inv = None
            if sort and r > 128:
                perm, inv = sort_points_device(pts, device=dev)
                pts, dm = _take(perm, pts, dm)
        with obs.span("prologue"):
            rows = point_rows(pts, dm)
        with obs.span("walk"):
            d2, lane_id = _nearest_walk(scene, rows, wide)
        with obs.span("epilogue"):
            hit = torch.isfinite(d2)
            if dm is not None:
                # the key truncates d2 downward (lane bits), so the exact
                # radius filters here, after the walk
                hit = hit & (d2 < dm * dm)
            tri_map = _dev(scene.tri_map, dev)
            lane = lane_id.clamp(0, tri_map.shape[0] - 1).to(torch.int64)
            sid = torch.where(hit, tri_map[lane], -1)
            # the square root in float64, rounded once to float32: the
            # correctly rounded root on every device (the card's float32
            # sqrt may sit 1 ulp off it)
            root = torch.sqrt(torch.clamp_min(d2, 0.0).double()).float()
            dist = torch.where(hit, root, _INF)
            return (sid, dist) if inv is None else _unsort(inv, sid, dist)


def _nearest_walk(scene, rows, wide: bool | None, counts: bool = False):
    """``nearest_tight``'s walk over the point rows: the walk's choice
    (``wide`` as there; packed scenes raise), the bound seed in place on
    ``rows[3]`` where the scene takes one (else ``nearest.unseeded`` is
    counted, unless ``counts``), then the group or entry/exit launch:
    ``(d2, lane_id)``; with ``counts`` the counting builds' ``(steps,
    fires)`` per point, the seed's group tests among the steps."""
    if scene.packed_nodes is not None:
        raise ValueError("nearest walks read f32 node tables (build with "
                         "packed=False)")
    if wide is None:
        wide = scene.gnodes is not None
    elif wide and scene.gnodes is None:
        raise ValueError("scene built without wide tables (gnodes)")
    dev = rows.device
    seed_steps = 0
    if _seeds(scene):
        seed_steps = nearest_seed(_dev(scene.gnodes, dev), rows, counts=counts)
    elif not counts:
        obs.count("nearest.unseeded")
    args = (_dev(scene.groups, dev), rows, int(scene.width))
    kw = dict(refine=not scene.masked, counts=counts, a_lo=_a_lo(scene, dev))
    if wide:
        out = nearest_wide(_dev(scene.gnodes, dev), *args, int(scene.gdepth),
                           **kw)
    else:
        out = nearest_entry_exit(_dev(scene.smem_nodes, dev), *args, **kw)
    return (out[2] + seed_steps, out[3]) if counts else out


def nearest_chained(chained, points, packet: int = 2048, d_max=None,
                    sort: bool = True, device=None):
    """Nearest triangle over a ``ChainedScene``: ``(shape_id [n] int32,
    distance [n] float32)`` with global triangle ids, the contract of
    ``nearest_tight``.

    The batch is sorted once (``sort``, more than 128 points), then the
    parts run in turn, each point's best distance so far the next part's
    radius; a part's triangle replaces the best only when strictly closer,
    so ties go to the earlier part. Each part takes its own frame: a part
    that carries ``a_lo`` runs the FRAME builds, a part whose caller set
    it to None the others. The carried radius is the winner's distance
    from its truncated key, so a later part's triangle within that
    truncation of the best may be left out (the key-truncation class).
    Ids are mapped once at the end, and the un-permute moves int32 bit
    patterns. A call is one ``obs`` span ``nearest_chained``, around a
    ``nearest`` a part.
    """
    _check_packet(packet)
    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev).reshape(-1, 3)
    r = pts.shape[0]
    if r == 0:
        return (torch.full((0,), -1, dtype=torch.int32, device=dev),
                torch.full((0,), _INF, dtype=torch.float32, device=dev))
    with obs.span("nearest_chained"):
        if d_max is None:
            best_d = torch.full((r,), _INF, dtype=torch.float32, device=dev)
        else:
            best_d = torch.as_tensor(d_max, dtype=torch.float32, device=dev)
            best_d = best_d.reshape(-1).expand(r).contiguous()
        inv = None
        if sort and r > 128:
            perm, inv = sort_points_device(pts, device=dev)
            pts, best_d = _take(perm, pts, best_d)
        # 0: the -1 slot
        best_loc = torch.zeros(r, dtype=torch.int64, device=dev)
        off = 1
        for part, ids in zip(chained.parts, chained.orig_ids):
            sid, dist = nearest_tight(part, pts, packet=packet, d_max=best_d,
                                      sort=False, device=dev)
            closer = (sid >= 0) & (dist < best_d)
            best_d = torch.where(closer, dist, best_d)
            best_loc = torch.where(closer, sid.to(torch.int64) + off, best_loc)
            off += int(ids.shape[0])
        best_id = _chain_ids(chained, dev)[best_loc]
        best_d = torch.where(best_id >= 0, best_d, _INF)
        if inv is None:
            return best_id, best_d
        return _unsort(inv, best_id, best_d)


def count_visits_nearest(scene, points, packet: int = 2048,
                         wide: bool | None = None, device=None):
    """Steps and leaf fires of ``nearest_tight``'s walk, per packet of
    ``packet`` points in the given order (no sort): ``(steps, fires)``,
    int64 tensors [ceil(n / packet)] on ``device`` (None: the card). The
    walk is the scene's default (``wide=None``: the group walk where the
    scene has ``gnodes``), without a radius, refining its bound unless the
    scene is masked, from the bound seed where ``nearest_tight`` takes one,
    as ``nearest_tight`` walks it.

    A packet's count is the sum over its points of each point's own walk's
    count: steps are the groups whose 16 children the point tests (the
    entry/exit walk: the nodes it tests), the seed's descent included, fires
    the leaves it narrowphases (``nearest_seed_plain(counts=True)`` on the
    rows, then ``nearest_*_plain(counts=True)`` on the seeded rows). The
    kernels walk a warp of 32 points over the union of their nodes; a
    point's count is what its own walk tests, not what its warp steps
    through. The reference counts one
    shared cursor a packet, so its numbers are of another unit. On the card
    this launches the kernel's counting build (a debug build, never timed),
    whose results are the timed build's bit for bit."""
    _check_packet(packet)
    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev).reshape(-1, 3)
    if pts.shape[0] == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z
    steps, fires = _nearest_walk(scene, point_rows(pts, None), wide,
                                 counts=True)
    return packet_sums(steps, packet), packet_sums(fires, packet)
