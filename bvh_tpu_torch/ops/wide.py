"""Wide (16-ary) group-walk closest-hit and any-hit trace: the kernel's
wrapper, its launch count and its plain PyTorch version, and the leaf test
and key folding that the entry/exit walk (``ops/tight.py``) shares.

Replaces the TPU kernel ``bvh_tpu/ops/trace.py::_wide_body`` (with
``_make_mask_walk``, ``_ctz16`` and the leaf test ``_narrow_cluster``). The
CUDA kernel (``csrc/wide_trace.cu``, leaf test in ``csrc/trace_common.cuh``)
walks one ray a lane, in lock step, reads the table in a group-major copy
(``group_records``) and tests the leaves its lanes fire with the whole
warp; the plain version below computes the same function, ray by ray, in
lock step over a batch, and rounds every operation as the kernel does, so
the two agree bit for bit on the card.

Per ray: narrowphase the hinted leaf slots of its packet, if any; test group
0's 16 children against the bound ``vb`` (``t_max``, +inf when unbounded);
narrowphase the fired leaf children in ascending slot order; then enter the
fired interior children lowest slot first, depth first. With subtree entry
(``start_g``, the reference's ``SUBTREE`` walk) the packet's entry groups
``(sg, sg2)`` are walked first, each from an empty stack: the walk from
``sg``, then the walk from ``sg2`` that never enters ``sg``, then the walk
from group 0 that enters neither; ids <= 0 are inert. A subtree a later
walk skips was walked whole before, so every leaf the walk from group 0
would test is still tested, in another order; the entries only tighten
the bound sooner, and the result equals the walk's without them (the
tests hold it so for any entries). A leaf narrowphase
keeps the smallest packed key (the bits of ``t`` with the low log2(W) bits
replaced by the lane) and sets ``vb`` to the key's ``t`` (closest), to
``min(t, vb)`` (bounded), or to -inf once ``t < t_max`` and ``t_max``
otherwise (any: the ray is occluded and fires no box again).

Inputs: ``gnodes [113, Gn]`` and ``groups [G, 16, 128]`` float32 (see
``ops/cluster.py``) and the ray rows ``rays [13, n]`` float32:
o·inv (3), inv clamped to ±1e30 (3), t_max, d (3), o (3).

The leaf test evaluates the reference's four bilinear forms (det, u·det,
v·det, t·det) regrouped around the ray origin in the triangle's own frame,
tv = o' - a' with o' = o - cc: the reference sums terms of the size of the
cluster frame, m = o×d and cc×d at 1e5, and so loses up to ~0.01 of a unit
at triangle edges (rays hit across an edge, or through a crack between two
triangles). The regrouped form is exact to the rounding of the triangle's
own size; results differ from the reference only in its grazing-edge and
near-tie classes. A ray whose origin lies ~1e5 from a leaf rounds o' = o
- cc at ~0.004 of a unit whoever built the scene, and a device build's
Morton cluster may lie as far from its frame origin, where a' rounds as
much. So every scene that carries ``a_lo`` (every scene the port builds or
loads) is tested in the exact cluster frame by the kernel's FRAME build
(``exact_frame``, ``narrow_keys``'s ``frame``): tv = (o' + lo) - (a' +
a_lo) and w = tv × d in float64, with lo the rounding error of o' and a_lo
that of a', each rounded to float32 once.
Output per ray: ``t`` float32 (the key's bits with the lane bits cleared,
+inf on a miss) and ``lane_id`` int32 (cluster·W + lane, -1 on a miss).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import obs
from ._build import load_cuda_library

K = 16  # children per group
WIDE_DMAX = 16  # per-ray DFS stack depth
# the deepest wide tree the kernels take: the nearest group walk orders a
# warp's groups by a 64-bit key of 4 bits a level below the root, and the
# scene build (ops/cluster.py) makes no deeper table
MAX_DEPTH = 14
SENT = 0x7F800000  # +inf bits: the "no hit" key
_INF = float("inf")
_EPS = float(torch.finfo(torch.float32).eps)

# float32 operations per slab test of a child or of a sweep node (6 mul,
# 6 sub, 10 min/max, 1 max with 0, 2 compares); per (ray, triangle) test
# (tv 3, w = tv x d 9, the four forms 4 x 5 + 2 negations, 6 hit compares
# and 2 adds/muls for the bounds, reciprocal and product 2); per triangle,
# whatever the number of rays tested against it, p = e2 x e1 (9: a bound
# charges it once for every triangle of the scene); and per fired leaf the
# ray origin moved to the cluster frame (centre 6, o' 3)
SLAB_OPS = 25
TRI_OPS = 44
TRI_ONCE_OPS = 9
LEAF_OPS = 9
# the FRAME builds' extra operations, in float32 equivalents (a float64
# operation counts two: the H100's float64 rate is half its float32 rate):
# per (ray, triangle) test a' + a_lo (3 in float64, 6 conversions in), the
# difference (3) and w = tv x d (9) in float64, tv and w rounded (6
# conversions out), less the float32 tv and w they replace (12); per fired
# leaf the rounding error lo of o - cc (``two_diff`` beyond the rounded
# difference, 5 an axis), o - cc = o' + lo in float64 (3, 6 conversions
# in) and d's 3 conversions
FRAME_TRI_OPS = (3 + 3 + 9) * 2 + 6 + 6 - 12
FRAME_LEAF_OPS = 15 + 3 * 2 + 6 + 3
N_ROWS = 13  # ray rows: o*inv (3), inv (3), t_max, d (3), o (3)
REC = 128  # floats per group in the kernel's group-major table

MODES = {"closest": 0, "any": 2}  # the kernels' mode codes (1: bounded)


@functools.cache
def load() -> ctypes.CDLL:
    """Builds (first call) and loads ``csrc/wide_trace.cu``."""
    return bind(load_cuda_library("wide_trace", "wide_trace.cu"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a build of ``wide_trace.cu``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wide_trace_launch.restype = ci
    lib.wide_trace_launch.argtypes = [vp, vp, ci, vp, ci, vp, ci, vp, vp, ci,
                                      ci, vp, vp, vp, vp, vp, vp]
    lib.wide_trace_rec_floats.restype = ci
    if lib.wide_trace_rec_floats() != REC:
        raise RuntimeError("wide_trace.cu's group record is not "
                           f"{REC} floats")
    return lib


def group_records(gnodes):
    """The kernel's group-major copy of a scene's ``gnodes [7K+1, Gn]``:
    [Gn, REC] float32, one 512-byte record a group holding its 16 child
    boxes (amin (3), amax (3) at 6k, read as float4 and in three 128-byte
    lines), the payloads at 6K + k and the leaf mask at 7K; the rest is 0.
    The values are the table's own. A numpy table gives a numpy array, a
    tensor a tensor on its device. Callers upload it once a table with
    ``ops/trace.py::_dev(gnodes, device, group_records)``."""
    g = torch.as_tensor(gnodes)
    gn = g.shape[1]
    box = g[:7 * K].reshape(K, 7, gn)
    rec = torch.zeros((gn, REC), dtype=torch.float32, device=g.device)
    rec[:, :6 * K] = box[:, :6].permute(2, 0, 1).reshape(gn, 6 * K)
    rec[:, 6 * K:7 * K] = box[:, 6].t()
    rec[:, 7 * K] = g[7 * K]
    return rec if torch.is_tensor(gnodes) else rec.numpy()


def wide_table(records: torch.Tensor) -> torch.Tensor:
    """``gnodes [7K+1, Gn]`` back from its records (``group_records``), for
    the plain version."""
    gn = records.shape[0]
    box = torch.cat([records[:, :6 * K].reshape(gn, K, 6),
                     records[:, 6 * K:7 * K, None]], 2)  # [Gn, K, 7]
    return torch.cat([box.reshape(gn, 7 * K), records[:, 7 * K:7 * K + 1]],
                     1).t().contiguous()


def mode_code(mode: str, bounded: bool) -> int:
    """The kernels' mode code: 0 closest, 1 bounded closest, 2 any."""
    if mode not in MODES:
        raise ValueError(f"mode must be 'closest' or 'any', got {mode!r}")
    return MODES[mode] or int(bool(bounded))


def check_options(rays: torch.Tensor, gate, hints, packet: int,
                  start_g=None) -> None:
    """Checks the per-packet inputs of a trace kernel: ``gate`` int32 [p],
    ``hints`` int32 [p, n_hints] and ``start_g`` int32 [p, 2] for
    p = ceil(n / packet)."""
    if packet < 128 or packet & (packet - 1):
        raise ValueError(f"packet must be a power of two >= 128, got {packet}")
    p = -(-rays.shape[1] // packet)
    if gate is not None and (
            gate.dtype != torch.int32 or tuple(gate.shape) != (p,)
            or gate.device != rays.device or not gate.is_contiguous()):
        raise ValueError(f"gate must be a contiguous int32 [{p}] tensor "
                         f"on {rays.device}")
    if hints is not None and (
            hints.dtype != torch.int32 or hints.dim() != 2
            or hints.shape[0] != p or hints.shape[1] < 1
            or hints.device != rays.device or not hints.is_contiguous()):
        raise ValueError(f"hints must be a contiguous int32 [{p}, n_hints] "
                         f"tensor on {rays.device}")
    if start_g is not None and (
            start_g.dtype != torch.int32 or tuple(start_g.shape) != (p, 2)
            or start_g.device != rays.device or not start_g.is_contiguous()):
        raise ValueError(f"start_g must be a contiguous int32 [{p}, 2] tensor "
                         f"on {rays.device}")


def check_a_lo(a_lo, groups, rays) -> None:
    """Checks a scene's exact-frame table: contiguous float32 [G, 3, 128]
    on the rays' device, G the groups'."""
    if a_lo is None:
        return
    if (a_lo.dtype != torch.float32 or not a_lo.is_contiguous()
            or a_lo.device != rays.device
            or tuple(a_lo.shape) != (groups.shape[0], 3, 128)):
        raise ValueError(f"a_lo must be a contiguous float32 "
                         f"[{groups.shape[0]}, 3, 128] tensor on {rays.device}")


def _check(records, groups, rays, width, depth, gate, hints, packet,
           start_g, a_lo):
    for name, x in (("records", records), ("groups", groups), ("rays", rays)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
        if x.device != rays.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rays.device}")
    if records.dim() != 2 or records.shape[1] != REC:
        raise ValueError(f"records must be [Gn, {REC}], got {tuple(records.shape)}")
    if groups.dim() != 3 or tuple(groups.shape[1:]) != (16, 128):
        raise ValueError(f"groups must be [G, 16, 128], got {tuple(groups.shape)}")
    if rays.dim() != 2 or rays.shape[0] != N_ROWS:
        raise ValueError(f"rays must be [{N_ROWS}, n], got {tuple(rays.shape)}")
    if width not in (16, 32, 64, 128):
        raise ValueError(f"width must be 16/32/64/128, got {width}")
    check_depth(depth)
    check_options(rays, gate, hints, packet, start_g)
    check_a_lo(a_lo, groups, rays)


def check_depth(depth: int) -> None:
    """Refuses a wide-tree depth outside 1..MAX_DEPTH."""
    if not 0 < depth <= MAX_DEPTH:
        raise ValueError(f"wide-tree depth {depth} outside 1..{MAX_DEPTH}")


def wide_trace(records: torch.Tensor, groups: torch.Tensor,
               rays: torch.Tensor, width: int, depth: int,
               gate: torch.Tensor | None = None, packet: int = 8192,
               bounded: bool = False, mode: str = "closest",
               hints: torch.Tensor | None = None,
               start_g: torch.Tensor | None = None, counts: bool = False,
               a_lo: torch.Tensor | None = None):
    """Closest or any hit of every ray: ``(t, lane_id)``; with ``counts``,
    ``(t, lane_id, group_tests, leaf_fires)``, each ray's group tests and
    fired leaf slots (int64; hinted leaves not counted), as
    ``wide_trace_plain(counts=True)`` gives them.

    ``records`` is the wide table in the kernel's layout
    (``group_records``), ``depth`` the wide tree's group depth
    (``TightScene.gdepth``).
    ``gate``: optional int32 [ceil(n / packet)]; rays of a packet whose gate
    is 0 are reported as misses without a walk. ``bounded``: the ``t_max``
    row is a real bound (keep ``vb <= t_max``). ``mode="any"``: a ray stops
    pruning, and the kernel ends its walk, once it has a hit below its
    ``t_max``; its ``t`` is then some hit's, not the closest. ``hints``:
    optional int32 [ceil(n / packet), n_hints] leaf slot ids g·K+k
    narrowphased first for the rays of each packet; -1 in a packet's first
    slot turns them off, and every other slot must then hold a leaf slot.
    ``start_g``: optional int32 [ceil(n / packet), 2] subtree entries of
    each packet (closest and bounded modes; ids <= 0 inert), walked before
    the walk from the root (see the module's docstring). Like the hints,
    its ids are not read back here (that would wait for the card): every
    id must be below Gn, as ``ops/trace.py`` checks. ``a_lo``: the scene's
    exact-frame table [G, 3, 128] (``TightScene.a_lo``), or None; given, the
    leaves are tested in the exact cluster frame (``narrow_keys``'s
    ``frame``) by the kernel's FRAME build.

    On a CPU tensor this runs the plain version (over ``wide_table``); on a
    CUDA tensor it launches the kernel: with ``counts`` its counting build
    (a debug build, not a timed one; its ``t`` and ``lane_id`` are the
    timed build's bit for bit).
    """
    _check(records, groups, rays, width, depth, gate, hints, packet, start_g,
           a_lo)
    code = mode_code(mode, bounded)
    if start_g is not None and code == 2:
        raise ValueError("start_g takes the closest and bounded modes")
    if rays.device.type == "cpu":
        return wide_trace_plain(wide_table(records), groups, rays, width,
                                gate=gate, packet=packet, bounded=bounded,
                                mode=mode, hints=hints, start_g=start_g,
                                counts=counts, a_lo=a_lo)
    if rays.device.type != "cuda":
        raise ValueError(f"no wide_trace kernel for device {rays.device}")
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    lane_id = torch.empty(n, dtype=torch.int32, device=rays.device)
    tests, fires = count_outputs(n, rays.device, counts)
    rc = load().wide_trace_launch(
        records.data_ptr(), groups.data_ptr(), width,
        rays.data_ptr(), n, 0 if hints is None else hints.data_ptr(),
        0 if hints is None else hints.shape[1],
        0 if gate is None else gate.data_ptr(),
        0 if start_g is None else start_g.data_ptr(), packet, code, t.data_ptr(),
        lane_id.data_ptr(), 0 if tests is None else tests.data_ptr(),
        0 if fires is None else fires.data_ptr(),
        0 if a_lo is None else a_lo.data_ptr(),
        torch.cuda.current_stream(rays.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wide_trace kernel launch failed: CUDA error {rc}")
    if counts:
        obs.count("launch.wide_trace_count")
        return t, lane_id, tests.to(torch.int64), fires.to(torch.int64)
    obs.launch("wide_trace", any=code == 2, subtree=start_g is not None,
               frame=a_lo is not None)
    return t, lane_id


def count_outputs(n: int, device, counts: bool):
    """The counting build's int32 outputs, two [n] counters zeroed (a ray
    of a gated-off packet keeps 0), or ``(None, None)`` for the timed
    build."""
    if not counts:
        return None, None
    return (torch.zeros(n, dtype=torch.int32, device=device),
            torch.zeros(n, dtype=torch.int32, device=device))


def _ctz16(low: torch.Tensor) -> torch.Tensor:
    """Bit index of a one-bit 16-bit mask."""
    k = torch.zeros_like(low)
    for bit, msk in ((1, 0xAAAA), (2, 0xCCCC), (4, 0xF0F0), (8, 0xFF00)):
        k = k + ((low & msk) != 0).to(low.dtype) * bit
    return k


def _cross_rows(u0, u1, u2, v0, v1, v2):
    return (u1 * v2 - u2 * v1, u2 * v0 - u0 * v2, u0 * v1 - u1 * v0)


def narrow_keys(rays: torch.Tensor, tiles: torch.Tensor, W: int,
                r: torch.Tensor, c: torch.Tensor, ccx, ccy, ccz,
                sent: int = SENT, row0: int = 7, frame=None):
    """Leaf tests of the (ray ``r[i]``, cluster ``c[i]``) pairs with frame
    origins ``cc``: each pair's smallest packed key over the cluster's W
    triangles, ``sent`` where none is below it. ``tiles`` is ``groups`` as
    [G, 128, 16] (lane-major); rows ``row0`` to ``row0 + 5`` of ``rays``
    hold d (3) and o (3).

    ``frame``: the exact cluster frame ``(lo, alo)`` (the legacy walk's,
    and the FRAME builds' of the group and entry/exit walks): ``lo =
    (lox, loy, loz)``, the rounding error of each pair's ``o - cc``
    (``two_diff``), and ``alo`` [G, 128, 3], the part of each
    triangle's ``a - cc`` that ``a'`` leaves out (``ClusterScene.a_lo`` or
    ``TightScene.a_lo``, lane-major); then ``tv = (o' + lo) - (a' + alo)``
    and ``w = tv x d`` are formed in float64 and each rounded to float32
    once (``csrc/trace_common.cuh::tri_key_frame``), so that the two
    triangles of an edge see the ray at one place; the rest of the test is
    float32 as without it."""
    dev = rays.device
    lanes = torch.arange(W, dtype=torch.int32, device=dev)
    per_row = 128 // W
    dx, dy, dz, ox, oy, oz = (rays[j, r] for j in range(row0, row0 + 6))
    # the ray origin in the cluster frame
    opx, opy, opz = (x[:, None] for x in (ox - ccx, oy - ccy, oz - ccz))
    dx, dy, dz = dx[:, None], dy[:, None], dz[:, None]
    lane = (c % per_row)[:, None] * W + lanes[None, :]
    tri = tiles[(c // per_row)[:, None], lane]  # [P, W, 16]
    a0, a1, a2 = (tri[..., j] for j in range(3))
    # the bilinear forms around tv = o' - a' (see csrc/trace_common.cuh)
    if frame is not None:
        lo, alo = frame
        al = alo[(c // per_row)[:, None], lane]  # [P, W, 3]
        tv = [(op.double() + lk[:, None].double())
              - (a.double() + al[..., k].double())
              for k, (op, lk, a) in enumerate(zip((opx, opy, opz), lo,
                                                  (a0, a1, a2)))]
        w0, w1, w2 = (x.float() for x in _cross_rows(
            *tv, dx.double(), dy.double(), dz.double()))
        tvx, tvy, tvz = (x.float() for x in tv)
    else:
        tvx, tvy, tvz = opx - a0, opy - a1, opz - a2
        w0, w1, w2 = _cross_rows(tvx, tvy, tvz, dx, dy, dz)  # tv x d
    return tri_keys(tri, (tvx, tvy, tvz), (w0, w1, w2), (dx, dy, dz), W,
                    sent)


def tri_keys(tri: torch.Tensor, tv: tuple, w: tuple, d: tuple, W: int,
             sent: int) -> torch.Tensor:
    """The rest of the leaf test once tv = o - a and w = tv x d are formed
    (``csrc/trace_common.cuh::tri_key_w``): of each pair [P] against the W
    triangle rows ``tri`` [P, W, 16] (a', e1, e2), with tv and w [P, W]
    and d [P, 1], the smallest packed key, ``sent`` where none is below
    it."""
    e10, e11, e12, e20, e21, e22 = (tri[..., j] for j in range(3, 9))
    (tvx, tvy, tvz), (w0, w1, w2), (dx, dy, dz) = tv, w, d
    p0, p1, p2 = _cross_rows(e20, e21, e22, e10, e11, e12)  # e2 x e1
    det = (p0 * dx + p1 * dy) + p2 * dz
    udet = (e20 * w0 + e21 * w1) + e22 * w2
    vdet = -((e10 * w0 + e11 * w1) + e12 * w2)
    tdet = -((p0 * tvx + p1 * tvy) + p2 * tvz)
    ok = (~(det < _EPS) & (udet >= 0.0) & (udet <= det) & (vdet >= 0.0)
          & (udet + vdet <= det) & (tdet > _EPS * det))
    t = tdet * (1.0 / det)
    lanes = torch.arange(W, dtype=torch.int32, device=tri.device)
    sent = torch.full((), sent, dtype=torch.int32, device=tri.device)
    key = torch.where(ok, (t.view(torch.int32) & -W) | lanes[None, :], sent)
    return torch.minimum(key.amin(dim=1), sent)


def exact_frame(rays: torch.Tensor, r: torch.Tensor, cc: tuple,
                a_lo: torch.Tensor | None):
    """``narrow_keys``'s ``frame`` for the (ray ``r[i]``, frame origin
    ``cc``) pairs of a scene with the exact-frame table ``a_lo``
    [G, 3, 128]: each pair's rounding error of o - cc (``two_diff``; o in
    rows 10-12 of ``rays``) and ``a_lo`` lane-major; None without
    ``a_lo``."""
    if a_lo is None:
        return None
    lo = tuple(two_diff(rays[10 + j, r], cc[j])[1] for j in range(3))
    return lo, a_lo.permute(0, 2, 1)


def two_diff(o, cc):
    """``o - cc`` as a float pair ``(hi, lo)``: ``hi`` the rounded
    difference and ``lo`` its rounding error, so that ``hi + lo == o - cc``
    exactly (Knuth's TwoSum of ``o`` and ``-cc``; the kernels' order)."""
    hi = o - cc
    bv = hi - o
    av = hi - bv
    return hi, (o - av) - (cc + bv)


def new_bound(nt: torch.Tensor, vb: torch.Tensor, tmx: torch.Tensor | None,
              bounded: bool) -> torch.Tensor:
    """The bound after a leaf test whose best key has the value ``nt``:
    -inf below ``tmx`` and ``tmx`` above it where ``tmx`` (the rays' t_max,
    any mode) is given, else ``min(nt, vb)`` when ``bounded``, else ``nt``."""
    if tmx is not None:
        return torch.where(nt < tmx, -_INF, tmx)
    return torch.minimum(nt, vb) if bounded else nt


def fold_keys(r, km, kc, bk, bc, vb, W: int, bounded: bool, tmx=None) -> None:
    """Folds one leaf result per walker into the state, in place: walker
    ``r[i]`` found best key ``km[i]`` in cluster ``kc[i]`` (``r`` holds no
    walker twice). The best key is replaced only when strictly smaller;
    then ``vb`` is updated as ``new_bound`` says."""
    old = bk[r]
    closer = km < old
    nbk = torch.where(closer, km, old)
    bk[r] = nbk
    bc[r] = torch.where(closer, kc, bc[r])
    vb[r] = new_bound((nbk & -W).view(torch.float32), vb[r],
                      None if tmx is None else tmx[r], bounded)


def fired_leaves(fired: torch.Tensor, lmask: torch.Tensor):
    """From the fired bits ``fired [K, m]`` of m group tests and the groups'
    leaf masks ``lmask [m]``: the fired masks ``m`` (int32) and the fired
    leaf slots ``kk`` of walkers ``ii``."""
    kbits = torch.ones(K, dtype=torch.int32, device=fired.device) << torch.arange(
        K, dtype=torch.int32, device=fired.device)
    m = (fired.to(torch.int32) * kbits[:, None]).sum(0, dtype=torch.int32)
    kk, ii = torch.nonzero((m & lmask)[None, :] & kbits[:, None], as_tuple=True)
    return m, kk, ii


def decode_keys(bk: torch.Tensor, bc: torch.Tensor, W: int):
    """The kernels' outputs from the packed best keys and clusters: the
    key's value (its bits with the lane bits cleared; +inf where there is no
    hit) and the lane id cluster·W + lane (-1 where there is none)."""
    value = (bk & -W).view(torch.float32)
    lane_id = torch.where(bk < SENT, bc * W + (bk & (W - 1)),
                          torch.full_like(bk, -1))
    return value, lane_id


def fold_slots(r, ii, kk, km, kc, bk, bc, vb, W: int, bounded: bool,
               tmx=None) -> None:
    """Folds the leaf results of one group test into the walkers' state, in
    place: walker ``r[ii]`` fired leaf slot ``kk`` with best key ``km`` in
    cluster ``kc``. The kernels test the slots of one walker in ascending
    order and replace the best key only when strictly smaller, so the first
    slot holding the smallest key wins; then ``vb`` is updated once, as
    ``new_bound`` says (the leaf test does not read ``vb``, and the update
    after the last slot equals the kernels' update after every slot)."""
    dev = bk.device
    m = r.numel()
    keys = torch.full((K, m), SENT, dtype=torch.int32, device=dev)
    keys[kk, ii] = km
    clus = torch.zeros(K, m, dtype=torch.int32, device=dev)
    clus[kk, ii] = kc
    kmin = keys.amin(dim=0)
    karange = torch.arange(K, device=dev)
    first = torch.where(keys == kmin[None, :], karange[:, None],
                        K).amin(dim=0).clamp(max=K - 1)
    wc = clus.gather(0, first[None, :])[0]
    has = torch.zeros(m, dtype=torch.bool, device=dev)
    has[ii] = True
    fold_keys(r[has], kmin[has], wc[has], bk, bc, vb, W, bounded, tmx)


def dfs_walk(live: torch.Tensor, enter, pay_all: torch.Tensor, n: int,
             done=None, start: torch.Tensor | None = None,
             skip: tuple | None = None) -> None:
    """The group walk of the walkers ``live`` (of ``n``), in lock step.

    ``enter(r, g)`` tests group ``g[i]`` for walker ``r[i]``, runs its fired
    leaves and returns the fired interior bits. Each walker starts at its
    group of ``start`` (int64, one per walker of ``live``; None: group 0)
    with an empty stack, then enters the fired interior children lowest slot
    first, depth first, on a (group, remaining mask) stack of depth
    ``WIDE_DMAX``, as the kernels do. ``skip``: optional pair of int64 [n]
    group ids per ray; a child whose id equals either is never entered.
    ``done(r)``: optional; after the start, a walker for which it is True
    leaves the walk before its next step, as the kernels end it."""
    dev = live.device
    d = torch.zeros(n, dtype=torch.int64, device=dev)
    gid = torch.zeros(n, dtype=torch.int64, device=dev)
    mask = torch.zeros(n, dtype=torch.int32, device=dev)
    stk_g = torch.zeros(n, WIDE_DMAX, dtype=torch.int64, device=dev)
    stk_m = torch.zeros(n, WIDE_DMAX, dtype=torch.int32, device=dev)
    if live.numel():
        g0 = torch.zeros_like(live) if start is None else start
        gid[live] = g0
        mask[live] = enter(live, g0)
    while live.numel():
        if done is not None:
            live = live[~done(live)]
            if not live.numel():
                break
        has = mask[live] != 0
        h = live[has]
        if h.numel():
            mh = mask[h]
            k = _ctz16(mh & -mh).to(torch.int64)
            mask[h] = mh & (mh - 1)
            child = pay_all[k, gid[h]].to(torch.int64)
            if skip is not None:
                go = (child != skip[0][h]) & (child != skip[1][h])
                h, child = h[go], child[go]
            m2 = enter(h, child)
            push = m2 != 0
            hp = h[push]
            stk_g[hp, d[hp]] = gid[hp]
            stk_m[hp, d[hp]] = mask[hp]
            d[hp] += 1
            gid[hp] = child[push]
            mask[hp] = m2[push]
        p = live[~has]
        if p.numel():
            d[p] -= 1
            pa = p[d[p] >= 0]
            gid[pa] = stk_g[pa, d[pa]]
            mask[pa] = stk_m[pa, d[pa]]
        live = live[d[live] >= 0]


def run_hints(live: torch.Tensor, hints: torch.Tensor | None, packet: int,
              narrow_hint) -> None:
    """Runs ``narrow_hint(r, h)`` for every hint slot ``h`` of the walkers
    ``r`` of ``live`` whose packet's first hint is not -1, slot by slot."""
    if hints is None or not live.numel():
        return
    pkt = live // packet
    r = live[hints[pkt, 0] >= 0]
    for j in range(hints.shape[1]):
        if r.numel():
            narrow_hint(r, hints[r // packet, j].to(torch.int64))


def wide_trace_plain(gnodes: torch.Tensor, groups: torch.Tensor,
                     rays: torch.Tensor, width: int,
                     gate: torch.Tensor | None = None, packet: int = 8192,
                     bounded: bool = False, counts: bool = False,
                     mode: str = "closest",
                     hints: torch.Tensor | None = None,
                     start_g: torch.Tensor | None = None,
                     a_lo: torch.Tensor | None = None):
    """The kernel's function in plain PyTorch (any device).

    Returns ``(t, lane_id)``, or with ``counts=True``
    ``(t, lane_id, group_tests, leaf_fires)``: per ray, the groups whose 16
    children it tested and the leaf clusters it narrowphased over every
    walk (int64; hinted leaves are not counted). ``start_g``: the packets'
    subtree entries, walked as the module's docstring says. ``a_lo``: the
    scene's exact-frame table, as ``wide_trace`` takes it.
    """
    W = width
    dev = rays.device
    n = rays.shape[1]
    Gn = gnodes.shape[1]
    box = gnodes[:7 * K].view(K, 7, Gn)
    pay_all = box[:, 6]  # [K, Gn]
    lmask_all = gnodes[7 * K].to(torch.int32)  # [Gn]
    tiles = groups.permute(0, 2, 1)  # [G, 128, 16]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tmx = rays[6] if mode_code(mode, bounded) == 2 else None

    bk = torch.full((n,), SENT, dtype=torch.int32, device=dev)
    bc = torch.zeros(n, dtype=torch.int32, device=dev)
    vb = rays[6].clone()
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    fires = torch.zeros(n, dtype=torch.int64, device=dev)

    def narrow(rr, gg, kk):
        """Leaf tests of rays rr against the clusters in slots kk of groups
        gg: each pair's best key and cluster."""
        c = (-pay_all[kk, gg] - 1.0).to(torch.int64)
        ax, ay, az, bx, by, bz = (box[kk, j, gg] for j in range(6))
        cc = ((ax + bx) * 0.5, (ay + by) * 0.5, (az + bz) * 0.5)
        km = narrow_keys(rays, tiles, W, rr, c, *cc,
                         frame=exact_frame(rays, rr, cc, a_lo))
        return km, c.to(torch.int32)

    def narrow_hint(r, slot):
        km, kc = narrow(r, slot >> 4, slot & (K - 1))
        fold_keys(r, km, kc, bk, bc, vb, W, bounded, tmx)

    def enter(r, g):
        """Tests groups g (one per ray r), narrowphases the fired leaves and
        returns the fired interior bits."""
        bx6 = box[:, 0:6, g]  # [K, 6, m]
        oix, oiy, oiz, ix, iy, iz = (rays[j, r] for j in range(6))
        t1 = bx6[:, 0] * ix - oix
        t2 = bx6[:, 3] * ix - oix
        u1 = bx6[:, 1] * iy - oiy
        u2 = bx6[:, 4] * iy - oiy
        v1 = bx6[:, 2] * iz - oiz
        v2 = bx6[:, 5] * iz - oiz
        tmin = torch.maximum(torch.maximum(torch.minimum(t1, t2),
                                           torch.minimum(u1, u2)),
                             torch.minimum(v1, v2))
        tmax = torch.minimum(torch.minimum(torch.maximum(t1, t2),
                                           torch.maximum(u1, u2)),
                             torch.maximum(v1, v2))
        fired = (tmax >= torch.maximum(tmin, zero)) & (tmin < vb[r])
        lmask = lmask_all[g]
        m, kk, ii = fired_leaves(fired, lmask)
        if counts:
            tests[r] += 1
            fires.index_add_(0, r[ii], torch.ones_like(ii))
        if kk.numel():
            km, kc = narrow(r[ii], g[ii], kk)
            fold_slots(r, ii, kk, km, kc, bk, bc, vb, W, bounded, tmx)
        return m & ~lmask

    live = torch.arange(n, device=dev)
    if gate is not None:
        live = live[gate[live // packet] != 0]
    run_hints(live, hints, packet, narrow_hint)
    # an any-hit ray whose bound is -inf fires no box again
    done = None if tmx is None else (lambda r: vb[r] == -_INF)
    if start_g is None:
        dfs_walk(live, enter, pay_all, n, done)
    else:
        # the walk from sg, the walk from sg2 skipping sg, then the walk
        # from the root skipping both (ids <= 0 match no child)
        sg = torch.zeros(n, 2, dtype=torch.int64, device=dev)
        sg[live] = start_g[live // packet].to(torch.int64)
        s1, s2 = sg[:, 0], sg[:, 1]
        for first, skip in ((s1, None), (s2, (s1, s1))):
            on = live[first[live] > 0]
            dfs_walk(on, enter, pay_all, n, done, start=first[on], skip=skip)
        dfs_walk(live, enter, pay_all, n, done, skip=(s1, s2))

    t, lane_id = decode_keys(bk, bc, W)
    if counts:
        return t, lane_id, tests, fires
    return t, lane_id
