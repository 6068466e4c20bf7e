"""Pinhole camera rays (batched, differentiable in the eye position).
Counterpart of ``bvh_tpu/diff/camera.py``."""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ray import Ray


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v)


def camera_rays(eye, look_at, up, fov_deg: float, width: int, height: int,
                device=None) -> Ray:
    """Rays through the pixel centres of a ``height`` x ``width`` image,
    row-major, from ``eye`` towards ``look_at`` with ``up`` the image's up
    and ``fov_deg`` its vertical field of view. A tensor ``eye`` that
    requires grad carries its gradient into the rays' origins and
    directions. ``device``: where to make them (None: the card)."""
    dev = resolve_device(device)
    eye = torch.as_tensor(eye, dtype=torch.float32, device=dev)
    fwd = _unit(torch.as_tensor(look_at, dtype=torch.float32, device=dev) - eye)
    right = _unit(torch.linalg.cross(
        fwd, torch.as_tensor(up, dtype=torch.float32, device=dev)))
    cam_up = torch.linalg.cross(right, fwd)
    # in float32, as the reference takes it
    tan_half = torch.tan(torch.deg2rad(torch.tensor(
        fov_deg, dtype=torch.float32, device=dev)) * 0.5)
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) \
        / width * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) \
        / height * 2.0
    px, py = torch.meshgrid(xs * tan_half * (width / height), ys * tan_half,
                            indexing="xy")
    dirs = (fwd[None, None, :] + px[..., None] * right[None, None, :]
            + py[..., None] * cam_up[None, None, :]).reshape(-1, 3)
    return Ray.create(eye.expand(dirs.shape), dirs, device=dev)
