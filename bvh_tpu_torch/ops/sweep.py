"""Sweep gate: one bit per packet of rays, "does any ray of the packet reach
any leaf box within its t_max". The kernel's wrapper, its launch count, its
plain PyTorch version, the node-major copy of the entry/exit table that the
sweep and the entry/exit trace kernels read (``node_records``), and the
least work of a gate (``least_node_tests``).

Replaces the TPU kernel ``bvh_tpu/ops/trace.py::_sweep_body`` (launched by
``_sweep_tight`` with ``exit_on_fire=True``). The CUDA kernel
(``csrc/sweep.cu``) runs the stackless entry/exit walk over the node table
(box, entry, exit; leaves have entry < 0) one ray a thread, and every
thread of a packet stops once some ray of the packet has reached a leaf box
(the gate is an OR over the packet's rays, so the bit does not depend on
which ray is found first); the plain version runs every ray's walk to its
own first leaf, in lock step. A gate of 0 lets the trace skip the packet:
no ray of it can fire a narrowphase, so results are the same with the gate
on or off.

Options: a bf16-packed table ``[5, Nn]`` (``unpack_nodes``), and a
``pre_gate``: a packet whose pre-gate is 0 reports "not fired" without a
walk.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import obs
from ._build import load_cuda_library
from .wide import N_ROWS, check_options

NODE_REC = 8  # floats per node in the kernels' node-major table


@functools.cache
def load() -> ctypes.CDLL:
    """Builds (first call) and loads ``csrc/sweep.cu``."""
    lib = load_cuda_library("sweep", "sweep.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sweep_gate_launch.restype = ci
    lib.sweep_gate_launch.argtypes = [vp, ci, ci, vp, ci, vp, ci, vp, vp]
    lib.sweep_rec_floats.restype = ci
    if lib.sweep_rec_floats() != NODE_REC:
        raise RuntimeError(f"sweep.cu's node record is not {NODE_REC} floats")
    return lib


def node_records(table):
    """The kernels' node-major copy of an entry/exit table: [Nn, NODE_REC]
    float32, one 32-byte record a node, read as two float4. From an f32
    table ``[8, Nn]`` (``smem_nodes``, ``sweep_nodes``): box lo (3), box hi
    (3), entry, exit. From a packed table ``[5, Nn]`` (``packed_nodes``):
    the raw words of rows 0-2 (each axis's bf16 pair, unpacked by the
    kernel), 0 (3), entry, exit. The values are the table's own. A numpy
    table gives a numpy array, a tensor a tensor on its device. Callers
    upload it once a table with ``ops/trace.py::_dev(table, device,
    node_records)``."""
    t = torch.as_tensor(table)
    rows = t.shape[0]
    if rows not in (5, 8):
        raise ValueError(f"an entry/exit table has 5 or 8 rows, got {rows}")
    rec = torch.zeros((t.shape[1], NODE_REC), dtype=torch.float32,
                      device=t.device)
    if rows == 8:
        rec[:] = t.t()
    else:
        rec[:, 0:3] = t[0:3].t()
        rec[:, 6:8] = t[3:5].t()
    return rec if torch.is_tensor(table) else rec.numpy()


def node_table(records: torch.Tensor, packed: bool) -> torch.Tensor:
    """The entry/exit table ``[8, Nn]`` (``[5, Nn]`` when ``packed``) back
    from its records (``node_records``), for the plain versions."""
    rows = [0, 1, 2, 6, 7] if packed else list(range(NODE_REC))
    return records[:, rows].t().contiguous()


def check_nodes(nodes: torch.Tensor, rays: torch.Tensor, packed: bool) -> None:
    """Checks an entry/exit node table: float32 [8, Nn], or [5, Nn] when
    ``packed``, contiguous, on the rays' device."""
    rows = 5 if packed else 8
    if nodes.dtype != torch.float32 or not nodes.is_contiguous():
        raise ValueError("nodes must be a contiguous float32 tensor")
    if nodes.device != rays.device:
        raise ValueError(f"nodes are on {nodes.device}, rays on {rays.device}")
    if nodes.dim() != 2 or nodes.shape[0] != rows:
        raise ValueError(f"nodes must be [{rows}, Nn], got {tuple(nodes.shape)}")


def check_records(records: torch.Tensor, rays: torch.Tensor) -> None:
    """Checks an entry/exit table's records (``node_records``): contiguous
    float32 [Nn, NODE_REC] on the rays' device."""
    if records.dtype != torch.float32 or not records.is_contiguous():
        raise ValueError("records must be a contiguous float32 tensor")
    if records.device != rays.device:
        raise ValueError(f"records are on {records.device}, rays on "
                         f"{rays.device}")
    if records.dim() != 2 or records.shape[1] != NODE_REC:
        raise ValueError(f"records must be [Nn, {NODE_REC}], got "
                         f"{tuple(records.shape)}")


def unpack_nodes(nodes: torch.Tensor) -> torch.Tensor:
    """A packed [5, Nn] table in the [8, Nn] layout: each axis's box min is
    the high bf16 half of its word (bits & 0xFFFF0000), its max the low half
    moved up (bits << 16)."""
    bits = nodes[0:3].view(torch.int32).to(torch.int64)
    lo = (bits & 0xFFFF0000).to(torch.int32)  # wraps to the sign bit
    hi = ((bits & 0xFFFF) << 16).to(torch.int32)
    return torch.cat([lo.view(torch.float32), hi.view(torch.float32),
                      nodes[3:5]])


def sweep_gate(records: torch.Tensor, rays: torch.Tensor, packet: int,
               packed: bool = False,
               pre_gate: torch.Tensor | None = None) -> torch.Tensor:
    """int32 [ceil(n / packet)] gate (1: some ray of the packet reaches a
    leaf box). ``records`` is the entry/exit table in the kernel's layout
    (``node_records`` of the [8, Nn] float32 table, or of the [5, Nn]
    bf16-packed one with ``packed``), ``rays`` the [13, n] ray rows of
    ``ops/wide.py`` (rows 0-6 are read). ``pre_gate``: optional int32
    [ceil(n / packet)]; a packet whose pre-gate is 0 gets 0 without a walk.

    On a CPU tensor this runs the plain version (over ``node_table``); on a
    CUDA tensor it launches the kernel.
    """
    check_records(records, rays)
    if rays.dtype != torch.float32 or not rays.is_contiguous():
        raise ValueError("rays must be a contiguous float32 tensor")
    if rays.dim() != 2 or rays.shape[0] != N_ROWS:
        raise ValueError(f"rays must be [{N_ROWS}, n], got {tuple(rays.shape)}")
    check_options(rays, pre_gate, None, packet)
    if rays.device.type == "cpu":
        return sweep_gate_plain(node_table(records, packed), rays, packet,
                                packed=packed, pre_gate=pre_gate)
    if rays.device.type != "cuda":
        raise ValueError(f"no sweep_gate kernel for device {rays.device}")
    n = rays.shape[1]
    # zeroed here: the kernel only ever sets a packet's word to 1
    gate = torch.zeros(-(-n // packet), dtype=torch.int32, device=rays.device)
    rc = load().sweep_gate_launch(
        records.data_ptr(), records.shape[0], int(packed), rays.data_ptr(), n,
        0 if pre_gate is None else pre_gate.data_ptr(), packet,
        gate.data_ptr(), torch.cuda.current_stream(rays.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sweep_gate kernel launch failed: CUDA error {rc}")
    obs.launch("sweep")
    return gate


def sweep_gate_plain(nodes: torch.Tensor, rays: torch.Tensor, packet: int,
                     counts: bool = False, packed: bool = False,
                     pre_gate: torch.Tensor | None = None):
    """The kernel's function in plain PyTorch (any device), over the node
    table ``nodes`` ([8, Nn], or [5, Nn] with ``packed``). With
    ``counts=True`` also returns the per-ray number of node tests of each
    ray's walk to its own first leaf (its whole walk if it reaches none);
    with ``packet=1`` the gate is then each ray's own bit."""
    dev = rays.device
    n = rays.shape[1]
    nn = nodes.shape[1]
    if packed:
        nodes = unpack_nodes(nodes)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    fired = torch.zeros(n, dtype=torch.bool, device=dev)
    visits = torch.zeros(n, dtype=torch.int64, device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    live = torch.arange(n, device=dev)
    if pre_gate is not None:
        live = live[pre_gate[live // packet] != 0]
    while live.numel():
        c = cur[live]
        ax, ay, az, bx, by, bz, entry, exit_ = nodes[:, c]
        oix, oiy, oiz, ix, iy, iz, tmx = (rays[j, live] for j in range(7))
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
        useful = (tmax >= torch.maximum(tmin, zero)) & (tmin < tmx)
        leaf_hit = useful & (entry < 0.0)
        fired[live[leaf_hit]] = True
        visits[live] += 1
        nxt = torch.where(useful, entry, exit_).to(torch.int64)
        cur[live] = nxt
        live = live[~leaf_hit & (nxt < nn)]
    p = -(-n // packet)
    padded = torch.zeros(p * packet, dtype=torch.bool, device=dev)
    padded[:n] = fired
    gate = padded.view(p, packet).any(dim=1).to(torch.int32)
    if counts:
        return gate, visits
    return gate


def least_node_tests(visits: torch.Tensor, fired: torch.Tensor, packet: int,
                     pre_gate: torch.Tensor | None = None) -> tuple[int, int]:
    """The least work of a gate over packets of ``packet`` rays, whatever
    the schedule: a packet that fires needs the shortest walk to a fire
    among its rays, a packet that does not needs every one of its rays'
    whole walks. ``visits``: each ray's node tests and ``fired``: its own
    bit, from ``sweep_gate_plain(..., packet=1, counts=True)`` with the
    pre-gate spread to the rays. Returns (node tests, rays of the packets
    that the pre-gate leaves open and that do not fire): those rays' rows
    must be read."""
    n = visits.shape[0]
    p = -(-n // packet)
    v = torch.zeros(p * packet, dtype=torch.int64, device=visits.device)
    f = torch.zeros(p * packet, dtype=torch.bool, device=visits.device)
    v[:n], f[:n] = visits, fired.bool()
    v, f = v.view(p, packet), f.view(p, packet)
    hit = f.any(dim=1)
    shortest = torch.where(f, v, torch.iinfo(torch.int64).max).amin(dim=1)
    tests = int(shortest[hit].sum()) + int(v[~hit].sum())
    walked = ~hit if pre_gate is None else ~hit & (pre_gate != 0)
    size = torch.full((p,), packet, dtype=torch.int64, device=visits.device)
    size[-1] = n - (p - 1) * packet
    return tests, int(size[walked].sum())
