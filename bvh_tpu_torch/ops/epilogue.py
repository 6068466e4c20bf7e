"""The closest-hit trace's epilogue kernel: its wrapper and its launch count.

``csrc/epilogue.cu`` does in one launch what ``ops/trace.py``'s plain
epilogue (``_epilogue_plain``: the bound mask, ``_shape_ids``, ``_finish``
and ``_unpermute``) does in some 90 PyTorch operations, with the same
float32 operations in the same order, so the answers are equal bit for bit.
It replaces no ``pallas_call``: in the JAX package the same glue is one XLA
fusion. ``ops/trace.py::_epilogue`` chooses between the two: the kernel for
tensors on the card, the plain composition on the CPU and wherever the
caller differentiates through the recompute.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import obs
from ..bvh.traverse import HitRecord
from ._build import load_cuda_library
from .wide import N_ROWS


@functools.cache
def load() -> ctypes.CDLL:
    """Builds (first call) and loads ``csrc/epilogue.cu``."""
    lib = load_cuda_library("epilogue", "epilogue.cu")
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.closest_epilogue_launch.restype = ci
    lib.closest_epilogue_launch.argtypes = [vp, ci, vp, vp, vp, ci, vp, vp, vp,
                                            cl, cl, cl, ci, vp, vp, vp, vp, vp,
                                            vp]
    return lib


def _check(rows, t, lane_id, tri_map, tris, inv) -> None:
    dev = rows.device
    if t.dim() != 1:
        raise ValueError(f"t must be [n], got {list(t.shape)}")
    n = t.shape[0]
    want = [(rows, "rows", torch.float32, (N_ROWS, n)),
            (t, "t", torch.float32, (n,)),
            (lane_id, "lane_id", torch.int32, (n,)),
            (tri_map, "tri_map", torch.int32, (tri_map.shape[0],))]
    if inv is not None:
        want.append((inv, "inv", torch.int64, (n,)))
    for x, name, dtype, shape in want:
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rows on {dev}")
    if tri_map.shape[0] == 0:
        raise ValueError("tri_map is empty")
    if tris is None:
        return
    if len(tris) != 3:
        raise ValueError("tris must be (a, b, c)")
    for x, name in zip(tris, "abc"):
        if x.dtype != torch.float32:
            raise ValueError(f"triangle table {name} must be float32, got "
                             f"{x.dtype}")
        if (x.dim() != 2 or x.shape[1] != 3 or x.stride(1) != 1
                or x.shape[0] != tris[0].shape[0]):
            raise ValueError(f"triangle table {name} must be [n_tris, 3] "
                             "with unit column stride, as a, b and c are")
        if x.device != dev:
            raise ValueError(f"triangle table {name} is on {x.device}, rows "
                             f"on {dev}")


def closest_epilogue(rows: torch.Tensor, t: torch.Tensor,
                     lane_id: torch.Tensor, tri_map: torch.Tensor, tris=None,
                     bounded: bool = False,
                     inv: torch.Tensor | None = None) -> HitRecord:
    """``HitRecord(t, u, v, shape_id)`` of the walk's raw ``(t, lane_id)``
    in one launch, equal bit for bit to ``ops/trace.py::_epilogue_plain``.

    ``rows``: the kernels' ray rows [13, n] in the walk's order (its t_max
    row is the bound where ``bounded``, its d and o rows the rays of the
    recompute); ``tri_map``: the scene's lane-to-triangle map, int32;
    ``tris``: optional (a, b, c) float32 [n_tris, 3] tables (any row
    stride, a unit column stride) for the exact winner recompute, else
    u = v = 0; ``inv``: optional int64 [n] un-sorting permutation, answer
    row j taken from the walk's row ``inv[j]`` (the callers' order). Every
    tensor on one CUDA device; anything else raises.
    """
    _check(rows, t, lane_id, tri_map, tris, inv)
    if rows.device.type != "cuda":
        raise ValueError(f"no epilogue kernel for device {rows.device} (the "
                         "plain composition is ops/trace.py::_epilogue_plain)")
    n = t.shape[0]
    dev = rows.device
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_u = torch.empty(n, dtype=torch.float32, device=dev)
    out_v = torch.empty(n, dtype=torch.float32, device=dev)
    out_id = torch.empty(n, dtype=torch.int32, device=dev)
    ta, tb, tc = (None, None, None) if tris is None else tris
    rc = load().closest_epilogue_launch(
        rows.data_ptr(), n, t.data_ptr(), lane_id.data_ptr(),
        tri_map.data_ptr(), tri_map.shape[0],
        *(0 if x is None else x.data_ptr() for x in (ta, tb, tc)),
        *(0 if x is None else x.stride(0) for x in (ta, tb, tc)),
        int(bounded), 0 if inv is None else inv.data_ptr(), out_t.data_ptr(),
        out_u.data_ptr(), out_v.data_ptr(), out_id.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"epilogue kernel launch failed: CUDA error {rc}")
    obs.launch("trace_epilogue")
    return HitRecord(out_t, out_u, out_v, out_id)
