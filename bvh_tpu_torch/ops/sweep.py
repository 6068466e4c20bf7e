"""Sweep gate: one bit per packet of rays, "does any ray of the packet reach
any leaf box within its t_max". The kernel's wrapper, its launch count and
its plain PyTorch version.

Replaces the TPU kernel ``bvh_tpu/ops/trace.py::_sweep_body`` (launched by
``_sweep_tight`` with ``exit_on_fire=True``). The CUDA kernel
(``csrc/sweep.cu``) runs the stackless entry/exit walk over the node table
``[8, Nn]`` (box, entry, exit; leaves have entry < 0) one ray per thread
until a leaf box passes; the plain version runs the same walk in lock step.
A gate of 0 lets the trace skip the packet: no ray of it can fire a
narrowphase, so results are the same with the gate on or off.

Options: a bf16-packed table ``[5, Nn]`` (``unpack_nodes``), and a
``pre_gate``: a packet whose pre-gate is 0 reports "not fired" without a
walk.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_cuda_library
from .wide import N_ROWS, check_options

launches = 0  # kernel launches, counted in ``sweep_gate``


@functools.cache
def load() -> ctypes.CDLL:
    """Builds (first call) and loads ``csrc/sweep.cu``."""
    lib = load_cuda_library("sweep", "sweep.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sweep_gate_launch.restype = ci
    lib.sweep_gate_launch.argtypes = [vp, ci, ci, vp, ci, vp, ci, vp, vp]
    return lib


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


def unpack_nodes(nodes: torch.Tensor) -> torch.Tensor:
    """A packed [5, Nn] table in the [8, Nn] layout: each axis's box min is
    the high bf16 half of its word (bits & 0xFFFF0000), its max the low half
    moved up (bits << 16)."""
    bits = nodes[0:3].view(torch.int32).to(torch.int64)
    lo = (bits & 0xFFFF0000).to(torch.int32)  # wraps to the sign bit
    hi = ((bits & 0xFFFF) << 16).to(torch.int32)
    return torch.cat([lo.view(torch.float32), hi.view(torch.float32),
                      nodes[3:5]])


def sweep_gate(nodes: torch.Tensor, rays: torch.Tensor, packet: int,
               packed: bool = False,
               pre_gate: torch.Tensor | None = None) -> torch.Tensor:
    """int32 [ceil(n / packet)] gate (1: some ray of the packet reaches a
    leaf box). ``nodes`` is the [8, Nn] float32 entry/exit table (or the
    [5, Nn] bf16-packed one with ``packed``), ``rays`` the [13, n] ray rows
    of ``ops/wide.py`` (rows 0-6 are read). ``pre_gate``: optional int32
    [ceil(n / packet)]; a packet whose pre-gate is 0 gets 0 without a walk.

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the kernel.
    """
    global launches
    check_nodes(nodes, rays, packed)
    if rays.dtype != torch.float32 or not rays.is_contiguous():
        raise ValueError("rays must be a contiguous float32 tensor")
    if rays.dim() != 2 or rays.shape[0] != N_ROWS:
        raise ValueError(f"rays must be [{N_ROWS}, n], got {tuple(rays.shape)}")
    check_options(rays, pre_gate, None, packet)
    if rays.device.type == "cpu":
        return sweep_gate_plain(nodes, rays, packet, packed=packed,
                                pre_gate=pre_gate)
    if rays.device.type != "cuda":
        raise ValueError(f"no sweep_gate kernel for device {rays.device}")
    n = rays.shape[1]
    gate = torch.zeros(-(-n // packet), dtype=torch.int32, device=rays.device)
    rc = load().sweep_gate_launch(
        nodes.data_ptr(), nodes.shape[1], int(packed), rays.data_ptr(), n,
        0 if pre_gate is None else pre_gate.data_ptr(), packet,
        gate.data_ptr(), torch.cuda.current_stream(rays.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sweep_gate kernel launch failed: CUDA error {rc}")
    launches += 1
    return gate


def sweep_gate_plain(nodes: torch.Tensor, rays: torch.Tensor, packet: int,
                     counts: bool = False, packed: bool = False,
                     pre_gate: torch.Tensor | None = None):
    """The kernel's function in plain PyTorch (any device). With
    ``counts=True`` also returns the per-ray number of node tests."""
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
