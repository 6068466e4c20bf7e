"""Axis-aligned bounding boxes as structure-of-arrays tensors.

Counterpart of ``bvh_tpu/aabb.py``. An ``Aabb`` holds two tensors ``(min,
max)`` of shape ``[..., D]``, any D, float32 or float64; every operation is
batched, and a single box is the batch shape ``()``. The semantics follow
the reference: empty and infinite bounds, the join/grow algebra, the
``2 * size . size`` surface-area proxy (the SAH builders' metric, not the
geometric area) and the iq-style ``min_distance_squared``.

The constructors that take raw data (``with_bounds``, ``empty``,
``infinite``) place the boxes on ``device`` (None: the card); every other
method works on the tensors where they lie.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device


class Aabb(NamedTuple):
    """A batch of axis-aligned bounding boxes: tensors ``min``/``max`` of
    shape [..., D]."""

    min: torch.Tensor
    max: torch.Tensor

    # -- constructors ---------------------------------------------------------

    @staticmethod
    def with_bounds(min, max, device=None) -> "Aabb":
        """The boxes with these corners (numpy or tensors; their dtype is
        kept) on ``device``."""
        dev = resolve_device(device)
        return Aabb(torch.as_tensor(min, device=dev),
                    torch.as_tensor(max, device=dev))

    @staticmethod
    def empty(d: int = 3, batch_shape: tuple = (), dtype=torch.float32,
              device=None) -> "Aabb":
        """Empty boxes: min = +inf, max = -inf, so that grow and join start
        from them."""
        inf = torch.full(tuple(batch_shape) + (d,), float("inf"), dtype=dtype,
                         device=resolve_device(device))
        return Aabb(inf, -inf)

    @staticmethod
    def infinite(d: int = 3, batch_shape: tuple = (), dtype=torch.float32,
                 device=None) -> "Aabb":
        inf = torch.full(tuple(batch_shape) + (d,), float("inf"), dtype=dtype,
                         device=resolve_device(device))
        return Aabb(-inf, inf)

    @staticmethod
    def from_points(points: torch.Tensor) -> "Aabb":
        """The bounding box of ``points [..., K, D]`` along axis -2."""
        return Aabb(points.amin(dim=-2), points.amax(dim=-2))

    # -- predicates -----------------------------------------------------------

    def contains(self, p: torch.Tensor) -> torch.Tensor:
        """``min <= p <= max`` on every axis."""
        return torch.all((p >= self.min) & (p <= self.max), dim=-1)

    def approx_contains_eps(self, p: torch.Tensor, epsilon) -> torch.Tensor:
        return torch.all((p - self.min > -epsilon) & (p - self.max < epsilon),
                         dim=-1)

    def approx_contains_aabb_eps(self, other: "Aabb", epsilon) -> torch.Tensor:
        return (self.approx_contains_eps(other.min, epsilon)
                & self.approx_contains_eps(other.max, epsilon))

    def relative_eq(self, other: "Aabb", epsilon) -> torch.Tensor:
        return (torch.all(torch.abs(self.min - other.min) <= epsilon, dim=-1)
                & torch.all(torch.abs(self.max - other.max) <= epsilon, dim=-1))

    def intersects_aabb(self, other: "Aabb") -> torch.Tensor:
        """Overlap (touching counts): no separating axis."""
        separated = (self.max < other.min) | (other.max < self.min)
        return ~torch.any(separated, dim=-1)

    def is_empty(self) -> torch.Tensor:
        """True where min > max on any axis."""
        return torch.any(self.min > self.max, dim=-1)

    # -- algebra --------------------------------------------------------------

    def join(self, other: "Aabb") -> "Aabb":
        return Aabb(torch.minimum(self.min, other.min),
                    torch.maximum(self.max, other.max))

    def grow(self, p: torch.Tensor) -> "Aabb":
        return Aabb(torch.minimum(self.min, p), torch.maximum(self.max, p))

    def join_reduce(self, axis: int = 0) -> "Aabb":
        """The union of a batch of boxes along ``axis``."""
        return Aabb(self.min.amin(dim=axis), self.max.amax(dim=axis))

    # -- measures -------------------------------------------------------------

    def size(self) -> torch.Tensor:
        return self.max - self.min

    def center(self) -> torch.Tensor:
        """The midpoint without overflow: min * 0.5 + max * 0.5."""
        return self.min * 0.5 + self.max * 0.5

    def half_size(self) -> torch.Tensor:
        return (self.max - self.min) * 0.5

    def surface_area(self) -> torch.Tensor:
        """The reference's D-generic SAH proxy ``2 * size . size``."""
        s = self.size()
        return 2.0 * torch.sum(s * s, dim=-1)

    def volume(self) -> torch.Tensor:
        return torch.prod(self.size(), dim=-1)

    def largest_axis(self) -> torch.Tensor:
        """The index of the largest extent (the first of equal ones)."""
        return torch.argmax(self.size(), dim=-1)

    def min_distance_squared(self, point: torch.Tensor) -> torch.Tensor:
        """The squared distance from ``point`` to the closest point on or in
        the box: q = |p - center| - half_size, dist² = |max(q, 0)|²."""
        half = self.half_size()
        center = self.min + half
        q = torch.abs(point - center) - half
        out = torch.clamp_min(q, 0.0)
        return torch.sum(out * out, dim=-1)


def joint_aabb(aabb_min: torch.Tensor, aabb_max: torch.Tensor, axis: int = 0):
    """The union of a batch of boxes given as raw tensors: ``(min, max)``."""
    return aabb_min.amin(dim=axis), aabb_max.amax(dim=axis)
