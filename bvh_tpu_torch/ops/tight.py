"""Entry/exit-walk closest-hit and any-hit trace: the kernel's wrapper, its
launch count and its plain PyTorch version.

Replaces the TPU kernel ``bvh_tpu/ops/trace.py::_tight_body`` (with the
node reader ``_read_node`` and the leaf test ``_narrow_cluster``). It serves
every scene without a usable wide table: bf16-packed scenes, bmat scenes,
scenes built with ``wide=False`` and scenes whose wide table was dropped at
build. The CUDA kernel (``csrc/tight_trace.cu``, leaf test in
``csrc/trace_common.cuh``) walks one ray a lane, in lock step, reads the
table in a node-major copy (``ops/sweep.py::node_records``) and tests the
leaves its lanes fire with the whole warp; the plain version below computes
the same function, ray by ray, in lock step over a batch, and rounds every
operation as the kernel does, so the two agree bit for bit on the card.

Per ray: narrowphase the hinted leaves of its packet (node-table ids), if
any; then a cursor starts at 0 and runs while it is below the table's width
``Nn``. Each node's box is slab-tested against the bound ``vb`` (seeded
from ``t_max``); a leaf (entry < 0, meaning -(cluster+1)) that fires is
narrowphased; the cursor then moves to ``exit`` at a leaf or a node that
did not fire, else to ``entry``. Modes, keys and bound updates are the
group walk's (``ops/wide.py``); once an any-hit ray's ``vb`` is -inf no box
fires again and its walk ends.

``skip_narrow`` (the reference's ``SKIP_NARROW``; the kernel's SKIP build)
is the broadphase-only walk: no leaf is tested and no hint seeded, so the
bound stays at ``t_max``, every ray misses, and every node whose box the
ray meets below ``t_max`` is visited. It measures the leaf tests' share of
the walk.

Tables: ``smem_nodes [8, Nn]`` (box lo, box hi, entry, exit; a leaf's frame
origin is its box centre) or ``packed_nodes [5, Nn]`` (``packed=True``:
rows 0-2 each axis's (min, max) as bf16 halves of one float32 word,
lo = bits & 0xFFFF0000 and hi = bits << 16, rows 3-4 entry and exit; a
leaf's frame origin is the raw float value of rows 0-2, against which the
scene build stored the group rows).

Leaf test on bmat scenes: a bmat scene keeps ``groups`` beside its
precomputed bilinear forms ``bgroups``. The port evaluates the leaf test
from ``groups`` with the regrouped forms around o - a (``ops/wide.py``);
``bgroups`` is built and carried but not read. The precomputed forms are the
reference's m = o×d forms, which lose up to ~3e-4 relative t at triangle
edges at 1e5 coordinates; results on bmat scenes equal the default scene's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import obs
from ._build import load_cuda_library
from .sweep import NODE_REC, check_records, node_table, unpack_nodes
from .wide import (N_ROWS, SENT, check_a_lo, check_options, count_outputs,
                   decode_keys, exact_frame, fold_keys, mode_code, narrow_keys,
                   run_hints)

# float32 operations per node visit beyond its slab test (``wide.SLAB_OPS``):
# the leaf test and the cursor select
STEP_OPS = 2


@functools.cache
def load() -> ctypes.CDLL:
    """Builds (first call) and loads ``csrc/tight_trace.cu``."""
    lib = load_cuda_library("tight_trace", "tight_trace.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tight_trace_launch.restype = ci
    lib.tight_trace_launch.argtypes = [vp, ci, ci, vp, ci, vp, ci, vp, ci, vp,
                                       ci, ci, vp, vp, vp, vp, vp, ci, vp]
    lib.tight_trace_rec_floats.restype = ci
    if lib.tight_trace_rec_floats() != NODE_REC:
        raise RuntimeError("tight_trace.cu's node record is not "
                           f"{NODE_REC} floats")
    return lib


def _check(records, groups, rays, width, gate, hints, packet, a_lo):
    for name, x in (("groups", groups), ("rays", rays)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
        if x.device != rays.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rays.device}")
    check_records(records, rays)
    if groups.dim() != 3 or tuple(groups.shape[1:]) != (16, 128):
        raise ValueError(f"groups must be [G, 16, 128], got {tuple(groups.shape)}")
    if rays.dim() != 2 or rays.shape[0] != N_ROWS:
        raise ValueError(f"rays must be [{N_ROWS}, n], got {tuple(rays.shape)}")
    if width not in (16, 32, 64, 128):
        raise ValueError(f"width must be 16/32/64/128, got {width}")
    check_options(rays, gate, hints, packet)
    check_a_lo(a_lo, groups, rays)


def tight_trace(records: torch.Tensor, groups: torch.Tensor,
                rays: torch.Tensor, width: int, packed: bool = False,
                gate: torch.Tensor | None = None, packet: int = 8192,
                bounded: bool = False, mode: str = "closest",
                hints: torch.Tensor | None = None, counts: bool = False,
                a_lo: torch.Tensor | None = None, skip_narrow: bool = False):
    """Closest or any hit of every ray by the entry/exit walk:
    ``(t, lane_id)``, as ``ops.wide.wide_trace`` returns them; with
    ``counts``, ``(t, lane_id, node_visits, leaf_fires)`` per ray (int64;
    hinted leaves not counted), as ``tight_trace_plain(counts=True)``
    gives them.

    ``records``: the entry/exit table in the kernel's layout
    (``ops/sweep.py::node_records`` of ``smem_nodes [8, Nn]``, or of
    ``packed_nodes [5, Nn]`` with ``packed``). ``gate``, ``packet``,
    ``bounded`` and ``mode`` as in ``wide_trace``. ``hints``: optional
    int32 [ceil(n / packet), n_hints] node-table ids of leaves narrowphased
    first for the rays of each packet; -1 in a packet's first slot turns
    them off, and every other slot must then hold a leaf's id. ``a_lo``:
    the scene's exact-frame table, as ``wide_trace`` takes it (the FRAME
    build). ``skip_narrow``: the broadphase-only walk (the SKIP build),
    every ray a miss; ``hints`` and ``a_lo`` are not read, and with
    ``counts`` the fires are 0 (no leaf is tested).

    On a CPU tensor this runs the plain version (over
    ``ops/sweep.py::node_table``); on a CUDA tensor it launches the kernel:
    with ``counts`` its counting build (a debug build, not a timed one; its
    ``t`` and ``lane_id`` are the timed build's bit for bit).
    """
    _check(records, groups, rays, width, gate, hints, packet, a_lo)
    code = mode_code(mode, bounded)
    if skip_narrow:
        # without leaf tests neither the hints nor the frame are read
        hints = a_lo = None
    if rays.device.type == "cpu":
        return tight_trace_plain(node_table(records, packed), groups, rays,
                                 width, packed=packed, gate=gate,
                                 packet=packet, bounded=bounded, mode=mode,
                                 hints=hints, counts=counts, a_lo=a_lo,
                                 skip_narrow=skip_narrow)
    if rays.device.type != "cuda":
        raise ValueError(f"no tight_trace kernel for device {rays.device}")
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    lane_id = torch.empty(n, dtype=torch.int32, device=rays.device)
    visits, fires = count_outputs(n, rays.device, counts)
    rc = load().tight_trace_launch(
        records.data_ptr(), records.shape[0], int(packed), groups.data_ptr(),
        width, rays.data_ptr(), n, 0 if hints is None else hints.data_ptr(),
        0 if hints is None else hints.shape[1],
        0 if gate is None else gate.data_ptr(), packet, code, t.data_ptr(),
        lane_id.data_ptr(), 0 if visits is None else visits.data_ptr(),
        0 if fires is None else fires.data_ptr(),
        0 if a_lo is None else a_lo.data_ptr(), int(skip_narrow),
        torch.cuda.current_stream(rays.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tight_trace kernel launch failed: CUDA error {rc}")
    if counts:
        obs.count("launch.tight_trace_count")
        return t, lane_id, visits.to(torch.int64), fires.to(torch.int64)
    obs.launch("tight_trace", any=code == 2, frame=a_lo is not None,
               skip=skip_narrow)
    return t, lane_id


def tight_trace_plain(nodes: torch.Tensor, groups: torch.Tensor,
                      rays: torch.Tensor, width: int, packed: bool = False,
                      gate: torch.Tensor | None = None, packet: int = 8192,
                      bounded: bool = False, mode: str = "closest",
                      hints: torch.Tensor | None = None,
                      counts: bool = False,
                      a_lo: torch.Tensor | None = None,
                      skip_narrow: bool = False):
    """The kernel's function in plain PyTorch (any device).

    Returns ``(t, lane_id)``, or with ``counts=True``
    ``(t, lane_id, node_visits, leaf_fires)`` per ray (int64; hinted leaves
    are not counted). ``a_lo`` and ``skip_narrow`` as in ``tight_trace``.
    """
    W = width
    dev = rays.device
    n = rays.shape[1]
    nn = nodes.shape[1]
    tiles = groups.permute(0, 2, 1)  # [G, 128, 16]
    # box lo (3), box hi (3), entry, exit; a leaf's frame origin (3)
    table = unpack_nodes(nodes) if packed else nodes
    frame = nodes[0:3] if packed else (table[0:3] + table[3:6]) * 0.5
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tmx = rays[6] if mode_code(mode, bounded) == 2 else None

    bk = torch.full((n,), SENT, dtype=torch.int32, device=dev)
    bc = torch.zeros(n, dtype=torch.int32, device=dev)
    vb = rays[6].clone()
    visits = torch.zeros(n, dtype=torch.int64, device=dev)
    fires = torch.zeros(n, dtype=torch.int64, device=dev)

    def narrow(r, node):
        """Leaf tests of rays r against the leaves at node-table ids node."""
        c = (-table[6, node] - 1.0).to(torch.int64)
        cc = tuple(frame[:, node])
        km = narrow_keys(rays, tiles, W, r, c, *cc,
                         frame=exact_frame(rays, r, cc, a_lo))
        fold_keys(r, km, c.to(torch.int32), bk, bc, vb, W, bounded, tmx)

    live = torch.arange(n if nn > 0 else 0, device=dev)
    if gate is not None:
        live = live[gate[live // packet] != 0]
    if not skip_narrow:
        run_hints(live, hints, packet, narrow)
    cursor = torch.zeros(n, dtype=torch.int64, device=dev)
    while live.numel():
        # an any-hit ray whose bound is -inf fires no box again
        live = live[vb[live] != -float("inf")]
        if not live.numel():
            break
        cur = cursor[live]
        ax, ay, az, bx, by, bz, entry, exit_ = table[:, cur]
        oix, oiy, oiz, ix, iy, iz = (rays[j, live] for j in range(6))
        t1 = ax * ix - oix
        t2 = bx * ix - oix
        u1 = ay * iy - oiy
        u2 = by * iy - oiy
        v1 = az * iz - oiz
        v2 = bz * iz - oiz
        tmin = torch.maximum(torch.maximum(torch.minimum(t1, t2),
                                           torch.minimum(u1, u2)),
                             torch.minimum(v1, v2))
        tmax = torch.minimum(torch.minimum(torch.maximum(t1, t2),
                                           torch.maximum(u1, u2)),
                             torch.maximum(v1, v2))
        fired = (tmax >= torch.maximum(tmin, zero)) & (tmin < vb[live])
        leaf = entry < 0.0
        hit_leaf = fired & leaf & (not skip_narrow)
        if counts:
            visits[live] += 1
            fires[live[hit_leaf]] += 1
        if hit_leaf.any():
            narrow(live[hit_leaf], cur[hit_leaf])
        nxt = torch.where(leaf | ~fired, exit_, entry).to(torch.int64)
        cursor[live] = nxt
        live = live[nxt < nn]

    t, lane_id = decode_keys(bk, bc, W)
    if counts:
        return t, lane_id, visits, fires
    return t, lane_id
