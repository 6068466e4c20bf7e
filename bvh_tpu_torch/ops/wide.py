"""Wide (16-ary) group-walk closest-hit trace: the kernel's wrapper, its
launch count and its plain PyTorch version.

Replaces the TPU kernel ``bvh_tpu/ops/trace.py::_wide_body`` (with
``_make_mask_walk``, ``_ctz16`` and the leaf test ``_narrow_cluster``). The
CUDA kernel (``csrc/wide_trace.cu``) walks one ray per thread; the plain
version below computes the same function, ray by ray, in lock step over a
batch, and rounds every operation as the kernel does, so the two agree bit
for bit on the card.

Per ray: test group 0's 16 children against the bound ``vb`` (``t_max``,
+inf when unbounded); narrowphase the fired leaf children in ascending slot
order; then enter the fired interior children lowest slot first, depth
first. A leaf narrowphase keeps the smallest packed key (the bits of ``t``
with the low log2(W) bits replaced by the lane) and sets ``vb`` to the key's
``t`` (closest) or to ``min(t, vb)`` (bounded).

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
near-tie classes.
Output per ray: ``t`` float32 (the key's bits with the lane bits cleared,
+inf on a miss) and ``lane_id`` int32 (cluster·W + lane, -1 on a miss).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_cuda_library

K = 16  # children per group
WIDE_DMAX = 16  # per-ray DFS stack depth
SENT = 0x7F800000  # +inf bits: the "no hit" key
_EPS = float(torch.finfo(torch.float32).eps)

# float32 operations per slab test of a child or of a sweep node (6 mul,
# 6 sub, 10 min/max, 1 max with 0, 2 compares) and per triangle test (tv 3,
# two cross
# products 18, the four forms 4 x 5 + 2 negations, 6 hit compares and 2
# adds/muls for the bounds, reciprocal and product 2); and per fired leaf
# the ray origin moved to the cluster frame (centre 6, o' 3)
SLAB_OPS = 25
TRI_OPS = 53
LEAF_OPS = 9
N_ROWS = 13  # ray rows: o*inv (3), inv (3), t_max, d (3), o (3)

launches = 0  # kernel launches, counted in ``wide_trace``


@functools.cache
def load() -> ctypes.CDLL:
    """Builds (first call) and loads ``csrc/wide_trace.cu``."""
    lib = load_cuda_library("wide_trace", "wide_trace.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wide_trace_launch.restype = ci
    lib.wide_trace_launch.argtypes = [vp, ci, vp, ci, vp, ci, vp, ci, ci,
                                      vp, vp, vp]
    return lib


def _check(gnodes, groups, rays, width, depth, gate, packet):
    for name, x in (("gnodes", gnodes), ("groups", groups), ("rays", rays)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
        if x.device != rays.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rays.device}")
    if gnodes.dim() != 2 or gnodes.shape[0] != 7 * K + 1:
        raise ValueError(f"gnodes must be [{7 * K + 1}, Gn], got {tuple(gnodes.shape)}")
    if groups.dim() != 3 or tuple(groups.shape[1:]) != (16, 128):
        raise ValueError(f"groups must be [G, 16, 128], got {tuple(groups.shape)}")
    if rays.dim() != 2 or rays.shape[0] != N_ROWS:
        raise ValueError(f"rays must be [{N_ROWS}, n], got {tuple(rays.shape)}")
    if width not in (16, 32, 64, 128):
        raise ValueError(f"width must be 16/32/64/128, got {width}")
    if not 0 < depth < WIDE_DMAX:
        raise ValueError(f"wide-tree depth {depth} outside 1..{WIDE_DMAX - 1}")
    if gate is not None:
        if packet < 128 or packet & (packet - 1):
            raise ValueError(f"packet must be a power of two >= 128, got {packet}")
        p = -(-rays.shape[1] // packet)
        if (gate.dtype != torch.int32 or tuple(gate.shape) != (p,)
                or gate.device != rays.device or not gate.is_contiguous()):
            raise ValueError(f"gate must be a contiguous int32 [{p}] tensor "
                             f"on {rays.device}")


def wide_trace(gnodes: torch.Tensor, groups: torch.Tensor, rays: torch.Tensor,
               width: int, depth: int, gate: torch.Tensor | None = None,
               packet: int = 8192, bounded: bool = False):
    """Closest hit of every ray: ``(t, lane_id)``.

    ``depth`` is the wide tree's group depth (``TightScene.gdepth``).
    ``gate``: optional int32 [ceil(n / packet)]; rays of a packet whose gate
    is 0 are reported as misses without a walk. ``bounded``: the ``t_max``
    row is a real bound (keep ``vb <= t_max``).

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the kernel.
    """
    global launches
    _check(gnodes, groups, rays, width, depth, gate, packet)
    if rays.device.type == "cpu":
        return wide_trace_plain(gnodes, groups, rays, width, gate=gate,
                                packet=packet, bounded=bounded)
    if rays.device.type != "cuda":
        raise ValueError(f"no wide_trace kernel for device {rays.device}")
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    lane_id = torch.empty(n, dtype=torch.int32, device=rays.device)
    rc = load().wide_trace_launch(
        gnodes.data_ptr(), gnodes.shape[1], groups.data_ptr(), width,
        rays.data_ptr(), n, 0 if gate is None else gate.data_ptr(), packet,
        int(bounded), t.data_ptr(), lane_id.data_ptr(),
        torch.cuda.current_stream(rays.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wide_trace kernel launch failed: CUDA error {rc}")
    launches += 1
    return t, lane_id


def _ctz16(low: torch.Tensor) -> torch.Tensor:
    """Bit index of a one-bit 16-bit mask."""
    k = torch.zeros_like(low)
    for bit, msk in ((1, 0xAAAA), (2, 0xCCCC), (4, 0xF0F0), (8, 0xFF00)):
        k = k + ((low & msk) != 0).to(low.dtype) * bit
    return k


def _cross_rows(u0, u1, u2, v0, v1, v2):
    return (u1 * v2 - u2 * v1, u2 * v0 - u0 * v2, u0 * v1 - u1 * v0)


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


def fold_slots(r, ii, kk, km, kc, bk, bc, vb, W: int, bounded: bool) -> None:
    """Folds the leaf results of one group test into the walkers' state, in
    place: walker ``r[ii]`` fired leaf slot ``kk`` with best key ``km`` in
    cluster ``kc``. The kernels test the slots of one walker in ascending
    order and replace the best key only when strictly smaller, so the first
    slot holding the smallest key wins; then ``vb`` becomes the key's value
    (``min`` with the old ``vb`` when ``bounded``)."""
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
    rf, kmin, wc = r[has], kmin[has], wc[has]
    old = bk[rf]
    closer = kmin < old
    nbk = torch.where(closer, kmin, old)
    bk[rf] = nbk
    bc[rf] = torch.where(closer, wc, bc[rf])
    nt = (nbk & -W).view(torch.float32)
    vb[rf] = torch.minimum(nt, vb[rf]) if bounded else nt


def dfs_walk(live: torch.Tensor, enter, pay_all: torch.Tensor, n: int) -> None:
    """The group walk of the walkers ``live`` (of ``n``), in lock step.

    ``enter(r, g)`` tests group ``g[i]`` for walker ``r[i]``, runs its fired
    leaves and returns the fired interior bits. Each walker starts at group
    0, then enters the fired interior children lowest slot first, depth
    first, on a (group, remaining mask) stack of depth ``WIDE_DMAX``, as the
    kernels do."""
    dev = live.device
    d = torch.zeros(n, dtype=torch.int64, device=dev)
    gid = torch.zeros(n, dtype=torch.int64, device=dev)
    mask = torch.zeros(n, dtype=torch.int32, device=dev)
    stk_g = torch.zeros(n, WIDE_DMAX, dtype=torch.int64, device=dev)
    stk_m = torch.zeros(n, WIDE_DMAX, dtype=torch.int32, device=dev)
    if live.numel():
        mask[live] = enter(live, torch.zeros_like(live))
    while live.numel():
        has = mask[live] != 0
        h = live[has]
        if h.numel():
            mh = mask[h]
            k = _ctz16(mh & -mh).to(torch.int64)
            mask[h] = mh & (mh - 1)
            child = pay_all[k, gid[h]].to(torch.int64)
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


def wide_trace_plain(gnodes: torch.Tensor, groups: torch.Tensor,
                     rays: torch.Tensor, width: int,
                     gate: torch.Tensor | None = None, packet: int = 8192,
                     bounded: bool = False, counts: bool = False):
    """The kernel's function in plain PyTorch (any device).

    Returns ``(t, lane_id)``, or with ``counts=True``
    ``(t, lane_id, group_tests, leaf_fires)``: per ray, the groups whose 16
    children it tested and the leaf clusters it narrowphased (int64).
    """
    W = width
    dev = rays.device
    n = rays.shape[1]
    Gn = gnodes.shape[1]
    box = gnodes[:7 * K].view(K, 7, Gn)
    pay_all = box[:, 6]  # [K, Gn]
    lmask_all = gnodes[7 * K].to(torch.int32)  # [Gn]
    tiles = groups.permute(0, 2, 1)  # [G, 128, 16]
    lanes = torch.arange(W, dtype=torch.int32, device=dev)
    per_row = 128 // W
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sent = torch.full((), SENT, dtype=torch.int32, device=dev)

    bk = torch.full((n,), SENT, dtype=torch.int32, device=dev)
    bc = torch.zeros(n, dtype=torch.int32, device=dev)
    vb = rays[6].clone()
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    fires = torch.zeros(n, dtype=torch.int64, device=dev)

    def narrow(r, g, ii, kk):
        """Leaf tests of the fired (ray r[ii], slot kk of group g[ii]) pairs;
        returns each pair's best key and cluster."""
        rr, gg = r[ii], g[ii]
        c = (-pay_all[kk, gg] - 1.0).to(torch.int64)
        ax, ay, az, bx, by, bz = (box[kk, j, gg] for j in range(6))
        ccx, ccy, ccz = (ax + bx) * 0.5, (ay + by) * 0.5, (az + bz) * 0.5
        dx, dy, dz, ox, oy, oz = (rays[j, rr] for j in range(7, 13))
        # the ray origin in the cluster frame
        opx, opy, opz = (x[:, None] for x in (ox - ccx, oy - ccy, oz - ccz))
        dx, dy, dz = dx[:, None], dy[:, None], dz[:, None]
        lane = (c % per_row)[:, None] * W + lanes[None, :]
        tri = tiles[(c // per_row)[:, None], lane]  # [P, W, 16]
        a0, a1, a2, e10, e11, e12, e20, e21, e22 = (tri[..., j] for j in range(9))
        # the bilinear forms around tv = o' - a' (see csrc/wide_trace.cu)
        tvx, tvy, tvz = opx - a0, opy - a1, opz - a2
        p0, p1, p2 = _cross_rows(e20, e21, e22, e10, e11, e12)  # e2 x e1
        w0, w1, w2 = _cross_rows(tvx, tvy, tvz, dx, dy, dz)  # tv x d
        det = (p0 * dx + p1 * dy) + p2 * dz
        udet = (e20 * w0 + e21 * w1) + e22 * w2
        vdet = -((e10 * w0 + e11 * w1) + e12 * w2)
        tdet = -((p0 * tvx + p1 * tvy) + p2 * tvz)
        ok = (~(det < _EPS) & (udet >= 0.0) & (udet <= det) & (vdet >= 0.0)
              & (udet + vdet <= det) & (tdet > _EPS * det))
        t = tdet * (1.0 / det)
        key = torch.where(ok, (t.view(torch.int32) & -W) | lanes[None, :], sent)
        return key.amin(dim=1), c.to(torch.int32)

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
            km, kc = narrow(r, g, ii, kk)
            fold_slots(r, ii, kk, km, kc, bk, bc, vb, W, bounded)
        return m & ~lmask

    live = torch.arange(n, device=dev)
    if gate is not None:
        live = live[gate[live // packet] != 0]
    dfs_walk(live, enter, pay_all, n)

    t, lane_id = decode_keys(bk, bc, W)
    if counts:
        return t, lane_id, tests, fires
    return t, lane_id
