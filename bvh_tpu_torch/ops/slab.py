"""Slab count: how many of R rays x B boxes pass the slab test
(``ray.py::ray_intersects_aabb``). The kernel's wrapper, its launch count
and its plain PyTorch version.

It measures the card's isolated ray-box rate (bench.py's ray_aabb_1000 leg),
against which the trace walks' distance from their bound can be read. In the
JAX package the leg is one XLA fusion (bench.py's ``slab_all``) and no
``pallas_call``; plain PyTorch operations would write the R x B
intermediates to device memory and time that, so the card runs the
hand-written ``csrc/slab_count.cu`` (one ray a thread, the boxes staged in
shared memory, one atomic add a block).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import obs
from ..ray import Ray, ray_intersects_aabb
from ._build import load_cuda_library

# operations of one ray-box test, counted from the kernel: 6 differences, 6
# products, the per-axis min and max (6), the two 3-way reductions (4), the
# clamp at 0 (1), the compare (1) and the add to the ray's count (1). The
# NaN tests cost no instruction of their own: every min and max propagates
# NaN (PTX min.NaN, max.NaN), so a NaN product fails the compare.
SLAB_COUNT_OPS = 6 + 6 + 6 + 4 + 1 + 1 + 1
# rays x boxes a call of the plain version takes at a time: each [r, B, 3]
# intermediate of a chunk is 48 MB
PLAIN_CHUNK = 1 << 22


@functools.cache
def load() -> ctypes.CDLL:
    """Builds (first call) and loads ``csrc/slab_count.cu``."""
    lib = load_cuda_library("slab_count", "slab_count.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.slab_count_launch.restype = ci
    lib.slab_count_launch.argtypes = [vp, vp, ci, vp, vp, ci, vp, vp]
    return lib


def _check(x: torch.Tensor, name: str, dev) -> None:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"{name} must be [n, 3], got {tuple(x.shape)}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, the rays on {dev}")


def slab_count(origin: torch.Tensor, inv_direction: torch.Tensor,
               box_min: torch.Tensor, box_max: torch.Tensor) -> torch.Tensor:
    """The number of (ray, box) pairs that pass the slab test, a 0-d int64
    tensor on the rays' device: ``origin`` and ``inv_direction`` [R, 3]
    (``Ray.inv_direction``), ``box_min`` and ``box_max`` [B, 3], all
    contiguous float32 on one device.

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the kernel.
    """
    dev = origin.device
    for x, name in ((origin, "origin"), (inv_direction, "inv_direction"),
                    (box_min, "box_min"), (box_max, "box_max")):
        _check(x, name, dev)
    if origin.shape != inv_direction.shape or box_min.shape != box_max.shape:
        raise ValueError("origin and inv_direction, box_min and box_max must "
                         "match in shape")
    if dev.type == "cpu":
        return slab_count_plain(origin, inv_direction, box_min, box_max)
    if dev.type != "cuda":
        raise ValueError(f"no slab_count kernel for device {dev}")
    count = torch.zeros((), dtype=torch.int64, device=dev)
    rc = load().slab_count_launch(
        origin.data_ptr(), inv_direction.data_ptr(), origin.shape[0],
        box_min.data_ptr(), box_max.data_ptr(), box_min.shape[0],
        count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"slab_count kernel launch failed: CUDA error {rc}")
    obs.launch("slab_count")
    return count


def slab_count_plain(origin: torch.Tensor, inv_direction: torch.Tensor,
                     box_min: torch.Tensor, box_max: torch.Tensor,
                     chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """The kernel's function in plain PyTorch (any device):
    ``ray_intersects_aabb`` of every ray against every box, over chunks of
    rays of about ``chunk`` ray-box pairs, summed."""
    r, nb = origin.shape[0], box_min.shape[0]
    total = torch.zeros((), dtype=torch.int64, device=origin.device)
    step = max(1, chunk // max(nb, 1))
    for s in range(0, r, step):
        o = origin[s:s + step, None, :]
        inv = inv_direction[s:s + step, None, :]
        # the slab test reads the origin and the inverse direction only
        hit = ray_intersects_aabb(Ray(o, None, inv), box_min[None],
                                  box_max[None])
        total += hit.sum()
    return total
