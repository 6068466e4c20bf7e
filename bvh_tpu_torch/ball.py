"""Balls (circles in 2-D, spheres in 3-D) as batched query volumes.

Counterpart of ``bvh_tpu/ball.py``: containment by squared distance and the
box test by the box's closest point. A ``Ball`` holds ``(center [..., D],
radius [...])`` tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device


class Ball(NamedTuple):
    center: torch.Tensor  # [..., D]
    radius: torch.Tensor  # [...]

    @staticmethod
    def create(center, radius, device=None) -> "Ball":
        """Balls on ``device`` (None: the card); the centre's dtype is kept
        and the radius takes it."""
        center = torch.as_tensor(center, device=resolve_device(device))
        return Ball(center, torch.as_tensor(radius, dtype=center.dtype,
                                            device=center.device))

    def contains(self, point: torch.Tensor) -> torch.Tensor:
        d = point - self.center
        return torch.sum(d * d, dim=-1) <= self.radius * self.radius

    def intersects_aabb(self, aabb_min: torch.Tensor,
                        aabb_max: torch.Tensor) -> torch.Tensor:
        closest = torch.minimum(torch.maximum(self.center, aabb_min), aabb_max)
        d = closest - self.center
        return torch.sum(d * d, dim=-1) <= self.radius * self.radius


Sphere = Ball
Circle = Ball
