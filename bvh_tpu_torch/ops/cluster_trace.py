"""Legacy ``ClusterScene`` closest-hit trace: the kernel's wrapper, its launch
count and its plain PyTorch version.

Replaces the TPU kernel ``bvh_tpu/ops/trace.py::_kernel_body`` (built by
``_make_kernel``, launched by ``_trace``). The TPU kernel walks one shared
cursor per packet and tests a fired leaf's 128 triangles against every ray
of the packet on the matrix unit. The CUDA kernel
(``csrc/cluster_trace.cu``) walks each ray on its own cursor in the same DFS
order, a warp of 32 rays at a time: the warp steps through the union of its
rays' nodes in table order, and the rays that fire a leaf share its 128
triangles, four a lane. The plain version below computes the same function,
ray by ray, in lock step over a batch, and rounds every operation as the
kernel does, so the two agree bit for bit on the card.

Per ray: a cursor starts at 0 and runs while it is below the table's width
``Nc``. Each node's box is slab-tested as ``(a - o) * inv`` with the
unclamped ``inv = 1/d`` (a ray in a face plane gives 0·inf = NaN, which
``torch.minimum``/``maximum`` carry, so that box never fires for it): it
fires when ``tmax >= max(tmin, 0)`` and ``tmin`` is below the ray's best t.
A fired leaf (entry -(cluster+1)) is narrowphased with the ray origin moved
to the cluster's frame (``smem_cc[:, c]`` on a relative scene, else 0); the
cluster's winner is its smallest key (the bits of t with the low 7 bits
replaced by the lane) and its t replaces the ray's best only when strictly
smaller, so a tie goes to the cluster visited first. The legacy "no hit"
key is 0x7F000000, not the other kernels' 0x7F800000: a t >= 2^127 counts
as no hit.

The leaf test runs in the exact cluster frame. The origin is kept as a
float pair, ``hi = o - cc`` rounded and ``lo`` its exact rounding error
(``two_diff``), and the scene carries the remainder ``a_lo = (a - cc) -
a'`` of its table's rounded ``a' = a - cc`` (``ClusterScene.a_lo``). Each
triangle test forms ``tv = (hi + lo) - (a' + a_lo)`` and ``w = tv x d`` in
float64 and rounds each to float32 once (``wide.narrow_keys``'s ``frame``,
the kernel's ``tri_key_frame``); the rest of the test is float32. A Morton
cluster's centre lies up to ~4e4 units from the world origin, and a ray's
origin may lie ~1e5 from the cluster, where float32 keeps ~0.004 of a
unit: ``o - cc`` and ``a'`` rounded there can move a ray onto the edge two
triangles share, and tv and w formed in float32 (``((hi - a') + lo) -
a_lo`` here before) round on their own in each triangle, so that the two
triangles of an edge see the ray apart and both edge tests round outside
(the crack class). The float64 form sees the ray at one place for both.

Where the per-ray walk differs from the TPU kernel's packet walk: the TPU
kernel narrowphases every ray of a packet at a leaf that any of its rays
opens and prunes by the packet's largest best t. A ray whose own slab test
misses a leaf by rounding (grazing edges) or is NaN (the face-plane rule)
can still take its hit from such a leaf there, and not here; otherwise the
two give the same closest hit up to the near-tie class.

Inputs: ``smem_nodes [8, Nc]``, ``smem_cc [4, C]``, ``tris_rel [C, 16,
128]`` and ``a_lo [C, 3, 128]`` float32, and the ray rows
``rays [9, n]`` float32: inv (3, unclamped), d (3), o (3). Output per ray:
``t`` float32 (the best key's value, +inf on a miss) and ``lane_id`` int32
(cluster·128 + lane, -1 on a miss).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import obs
from ._build import load_cuda_library
from .sweep import check_nodes
from .wide import FRAME_TRI_OPS, narrow_keys, two_diff
from .wide import TRI_OPS as WIDE_TRI_OPS

CW = 128  # triangles per cluster
LEGACY_SENT = 0x7F000000  # the legacy kernel's "no hit" key
N_ROWS = 9  # ray rows: inv (3, unclamped), d (3), o (3)
# float32 operations (a float64 one counts two) per (ray, triangle) test:
# ``wide.TRI_OPS`` with tv and w in float64, ``wide.FRAME_TRI_OPS`` (p =
# e2 x e1 is ``wide.TRI_ONCE_OPS``, once a triangle)
TRI_OPS = WIDE_TRI_OPS + FRAME_TRI_OPS
# per fired leaf beyond its 128 triangle tests: the origin's float pair
# (``two_diff``, 6 an axis), o - cc = hi + lo in float64 (3, 6 conversions
# in), d's 3 conversions and the fold's two compares; a node visit costs
# ``wide.SLAB_OPS`` plus ``tight.STEP_OPS``, as in the entry/exit walk
LEAF_OPS = 35
_INF = float("inf")


@functools.cache
def load() -> ctypes.CDLL:
    """Builds (first call) and loads ``csrc/cluster_trace.cu``."""
    return bind(load_cuda_library("cluster_trace", "cluster_trace.cu"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a build of ``cluster_trace.cu``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.cluster_trace_launch.restype = ci
    lib.cluster_trace_launch.argtypes = [vp, ci, vp, ci, vp, vp, vp, ci, ci,
                                         ci, vp, vp, vp]
    return lib


def check_f32(rays) -> None:
    """Refuses rays that are not float32: the trace kernels and their plain
    versions work in float32, and a float64 ray is not cast silently (the
    general path, ``bvh/traverse.py``, takes float64)."""
    if rays.origin.dtype != torch.float32:
        raise ValueError(f"the trace kernels take float32 rays, got "
                         f"{rays.origin.dtype} (use bvh.traverse for float64)")


def ray_rows(rays) -> torch.Tensor:
    """The legacy kernel's ray rows [9, n] of a ``Ray``: inv (unclamped), d,
    o; float32 rays only."""
    check_f32(rays)
    o, d, inv = rays
    return torch.stack([*inv.unbind(1), *d.unbind(1), *o.unbind(1)])


def _check(nodes, cc, tris, a_lo, rays):
    for name, x in (("smem_cc", cc), ("tris_rel", tris), ("a_lo", a_lo),
                    ("rays", rays)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
        if x.device != rays.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rays.device}")
    check_nodes(nodes, rays, packed=False)
    if tris.dim() != 3 or tuple(tris.shape[1:]) != (16, CW):
        raise ValueError(f"tris_rel must be [C, 16, {CW}], got {tuple(tris.shape)}")
    if tuple(a_lo.shape) != (tris.shape[0], 3, CW):
        raise ValueError(f"a_lo must be [{tris.shape[0]}, 3, {CW}], got "
                         f"{tuple(a_lo.shape)}")
    if cc.dim() != 2 or cc.shape[0] != 4 or cc.shape[1] != tris.shape[0]:
        raise ValueError(f"smem_cc must be [4, {tris.shape[0]}], got "
                         f"{tuple(cc.shape)}")
    if rays.dim() != 2 or rays.shape[0] != N_ROWS:
        raise ValueError(f"rays must be [{N_ROWS}, n], got {tuple(rays.shape)}")


def cluster_trace(nodes: torch.Tensor, cc: torch.Tensor, tris: torch.Tensor,
                  a_lo: torch.Tensor, rays: torch.Tensor, relative: bool = True,
                  skip_narrow: bool = False):
    """Closest hit of every ray over a ``ClusterScene``'s tables (``a_lo``
    included): ``(t, lane_id)``.

    ``relative``: the triangle rows are stored relative to ``smem_cc``
    (``ClusterScene.relative``). ``skip_narrow``: walk the tree without leaf
    tests; every ray is reported as a miss.

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the kernel.
    """
    _check(nodes, cc, tris, a_lo, rays)
    if rays.device.type == "cpu":
        return cluster_trace_plain(nodes, cc, tris, a_lo, rays,
                                   relative=relative, skip_narrow=skip_narrow)
    if rays.device.type != "cuda":
        raise ValueError(f"no cluster_trace kernel for device {rays.device}")
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    lane_id = torch.empty(n, dtype=torch.int32, device=rays.device)
    rc = load().cluster_trace_launch(
        nodes.data_ptr(), nodes.shape[1], cc.data_ptr(), cc.shape[1],
        tris.data_ptr(), a_lo.data_ptr(), rays.data_ptr(), n,
        int(bool(relative)),
        int(bool(skip_narrow)), t.data_ptr(), lane_id.data_ptr(),
        torch.cuda.current_stream(rays.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cluster_trace kernel launch failed: CUDA error {rc}")
    obs.launch("cluster_trace")
    return t, lane_id


def cluster_trace_plain(nodes: torch.Tensor, cc: torch.Tensor,
                        tris: torch.Tensor, a_lo: torch.Tensor,
                        rays: torch.Tensor, relative: bool = True,
                        skip_narrow: bool = False, counts: bool = False):
    """The kernel's function in plain PyTorch (any device).

    Returns ``(t, lane_id)``, or with ``counts=True``
    ``(t, lane_id, node_visits, leaf_fires)`` per ray (int64).
    """
    dev = rays.device
    n = rays.shape[1]
    nc = nodes.shape[1]
    tiles = tris.permute(0, 2, 1)  # [C, 128, 16]
    alo = a_lo.permute(0, 2, 1)  # [C, 128, 3]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    best = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    visits = torch.zeros(n, dtype=torch.int64, device=dev)
    fires = torch.zeros(n, dtype=torch.int64, device=dev)
    cursor = torch.zeros(n, dtype=torch.int64, device=dev)
    live = torch.arange(n if nc > 0 else 0, device=dev)
    while live.numel():
        cur = cursor[live]
        ax, ay, az, bx, by, bz, entry, exit_ = nodes[:, cur]
        ix, iy, iz = (rays[j, live] for j in range(3))
        ox, oy, oz = (rays[j, live] for j in range(6, 9))
        t1 = (ax - ox) * ix
        t2 = (bx - ox) * ix
        u1 = (ay - oy) * iy
        u2 = (by - oy) * iy
        v1 = (az - oz) * iz
        v2 = (bz - oz) * iz
        tmin = torch.maximum(torch.maximum(torch.minimum(t1, t2),
                                           torch.minimum(u1, u2)),
                             torch.minimum(v1, v2))
        tmax = torch.minimum(torch.minimum(torch.maximum(t1, t2),
                                           torch.maximum(u1, u2)),
                             torch.maximum(v1, v2))
        fired = (tmax >= torch.maximum(tmin, zero)) & (tmin < best[live])
        leaf = entry < 0.0
        hit_leaf = fired & leaf
        if counts:
            visits[live] += 1
            fires[live[hit_leaf]] += 1
        if not skip_narrow and hit_leaf.any():
            r = live[hit_leaf]
            c = (-entry[hit_leaf] - 1.0).to(torch.int64)
            if relative:
                ccs = (cc[0, c], cc[1, c], cc[2, c])
            else:
                ccs = (zero, zero, zero)
            # the origin in the cluster frame as a float pair: o - cc
            # rounded (narrow_keys forms it), and its rounding error lo
            lo = tuple(two_diff(rays[6 + j, r], ccs[j])[1] for j in range(3))
            km = narrow_keys(rays, tiles, CW, r, c, *ccs, sent=LEGACY_SENT,
                             row0=3, frame=(lo, alo))
            tc = (km & -CW).view(torch.float32)
            closer = (km < LEGACY_SENT) & (tc < best[r])
            best[r] = torch.where(closer, tc, best[r])
            best_id[r] = torch.where(closer, c.to(torch.int32) * CW
                                     + (km & (CW - 1)), best_id[r])
        nxt = torch.where(leaf | ~fired, exit_, entry).to(torch.int64)
        cursor[live] = nxt
        live = live[nxt < nc]
    if counts:
        return best, best_id, visits, fires
    return best, best_id
