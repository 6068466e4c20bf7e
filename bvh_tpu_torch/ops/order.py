"""The closest-hit tracer's coherence order and ray rows in hand-written
kernels: their wrappers and their launch counts.

``csrc/order.cu`` computes a batch's sort key in two launches (the origins'
bounds, then the key: ``ray_key``) and gathers the rays in the sorted order
straight into the walk's 13 ray rows, then writes the un-sorting
permutation, in two more (``ray_rows``). Their plain form is
``ops/trace.py``'s: ``_sort_key_plain``, then ``_sorted_rows_plain``
(``_inverse``'s scatter, ``_take``, ``Ray.create`` and ``_prologue``), some
90 PyTorch operations a call. The kernels take the same float32 operations
in the same order, so the key, the order and the rows are equal bit for
bit. They replace no ``pallas_call``: in the JAX package the same steps
are XLA fusions. ``ops/trace.py``'s ``_sort_key`` and ``_sorted_rows``
choose between the two by the rays' device: the kernels on the card (the
key and the rows carry no gradient), the plain composition on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import obs
from ._build import load_cuda_library
from .wide import N_ROWS

# the key's modes as the kernel numbers them
MODES = {"octant": 0, "morton": 1, "octmorton": 2}


@functools.cache
def load() -> ctypes.CDLL:
    """Builds (first call) and loads ``csrc/order.cu``."""
    lib = load_cuda_library("order", "order.cu")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ray_bounds_parts.restype = ci
    lib.ray_bounds_parts.argtypes = [ci]
    lib.ray_key_launch.restype = ci
    lib.ray_key_launch.argtypes = [vp, vp, ci, vp, ci, ci, cf, vp, vp]
    lib.ray_rows_launch.restype = ci
    lib.ray_rows_launch.argtypes = [vp, vp, vp, ci, vp, vp, vp]
    return lib


def _check_rays(o: torch.Tensor, d: torch.Tensor) -> None:
    for x, name in ((o, "origins"), (d, "directions")):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be [n, 3], got {list(x.shape)}")
    if d.shape != o.shape:
        raise ValueError(f"directions {list(d.shape)} and origins "
                         f"{list(o.shape)} must match")
    if d.device != o.device:
        raise ValueError(f"directions are on {d.device}, origins on "
                         f"{o.device}")


def _check_card(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no order kernel for device {dev} (the plain "
                         "composition is in ops/trace.py)")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def ray_key(o: torch.Tensor, d: torch.Tensor, mode: str,
            bits: int) -> torch.Tensor:
    """The coherence sort's int32 key [n] of rays ``o``, ``d`` (contiguous
    float32 [n, 3] on one CUDA device; anything else raises) in two
    launches (counted in ``launch.ray_bounds`` and ``launch.ray_key``),
    equal bit for bit to ``ops/trace.py::_sort_key_plain``:
    ``mode`` "octant" (octant, then the origin cell at ``bits`` an axis),
    "morton" (the origin's Morton cell, then the octant) or "octmorton"
    (octant major, Morton minor)."""
    if mode not in MODES:
        raise ValueError(f"unknown sort mode {mode!r}")
    _check_rays(o, d)
    _check_card(o.device)
    n = o.shape[0]
    lib = load()
    key = torch.empty(n, dtype=torch.int32, device=o.device)
    part = torch.empty(6 * lib.ray_bounds_parts(n), dtype=torch.float32,
                       device=o.device)
    rc = lib.ray_key_launch(o.data_ptr(), d.data_ptr(), n, part.data_ptr(),
                            MODES[mode], int(bits), float(2.0 ** bits - 1.0),
                            key.data_ptr(), _stream(o.device))
    if rc != 0:
        raise RuntimeError(f"key kernel launch failed: CUDA error {rc}")
    obs.launch("ray_bounds")
    obs.launch("ray_key")
    return key


def ray_rows(o: torch.Tensor, d: torch.Tensor,
             perm: torch.Tensor | None = None):
    """``(rows, inv)``: the walk's ray rows [13, n] of rays ``o``, ``d``
    (contiguous float32 [n, 3] on one CUDA device) taken in the order
    ``perm`` (int64 [n]; None: as given), the directions normalised as
    ``Ray.create`` does it, and ``inv`` the int64 permutation that un-sorts
    (None without ``perm``), in one launch (``launch.ray_rows``) and a
    second for the un-sort (``launch.ray_unsort``), equal bit for bit to
    ``ops/trace.py``'s ``_order``, ``_take``, ``Ray.create`` and
    ``_prologue``. Anything else raises."""
    _check_rays(o, d)
    n = o.shape[0]
    dev = o.device
    if perm is not None:
        if (perm.dtype != torch.int64 or not perm.is_contiguous()
                or tuple(perm.shape) != (n,)):
            raise ValueError(f"perm must be a contiguous int64 [{n}] tensor")
        if perm.device != dev:
            raise ValueError(f"perm is on {perm.device}, origins on {dev}")
    _check_card(dev)
    rows = torch.empty((N_ROWS, n), dtype=torch.float32, device=dev)
    inv = None if perm is None else torch.empty_like(perm)
    rc = load().ray_rows_launch(
        o.data_ptr(), d.data_ptr(), 0 if perm is None else perm.data_ptr(), n,
        rows.data_ptr(), 0 if inv is None else inv.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"rows kernel launch failed: CUDA error {rc}")
    obs.launch("ray_rows")
    if perm is not None:
        obs.launch("ray_unsort")
    return rows, inv
