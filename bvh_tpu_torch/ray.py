"""Rays and ray-primitive intersection on tensors.

Counterpart of ``bvh_tpu/ray.py``. A ``Ray`` holds tensors
``(origin, direction, inv_direction)`` of shape ``[..., D]``, float32 or
float64 (the slab tests take any D; the triangle test is 3-D). Numerics
follow the reference:

* slab test: NaN in either corner product => miss (ray in an AABB face
  plane), hit iff ``tmax >= max(tmin, 0)``;
* entry/exit slice: ``tmin = max(inf.max(), 0)``, miss when ``tmin > tmax``
  or NaN;
* Moller-Trumbore with backface culling (``det < eps``, the dtype's
  machine epsilon, => miss) and distance ``+inf`` on a miss.

The CUDA trace entry points (``ops/``) take float32 rays and raise on
float64 ones; the general path (``bvh/traverse.py``) takes either.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device

def _is_f64(x) -> bool:
    return getattr(x, "dtype", None) in (torch.float64, np.float64)


class Ray(NamedTuple):
    """A batch of rays; tensors of shape [..., D]. ``inv_direction`` is
    cached."""

    origin: torch.Tensor
    direction: torch.Tensor
    inv_direction: torch.Tensor

    @staticmethod
    def create(origin, direction, device=None, dtype=None) -> "Ray":
        """Builds a ray batch on ``device`` (None: the card); ``direction``
        is normalized as the reference's ``Ray::new``. ``dtype``: None keeps
        a float64 input (numpy or tensor) as float64 and makes every other
        input float32."""
        dev = resolve_device(device)
        if dtype is None:
            dtype = (torch.float64 if _is_f64(origin) or _is_f64(direction)
                     else torch.float32)
        origin = torch.as_tensor(origin, dtype=dtype, device=dev)
        direction = torch.as_tensor(direction, dtype=dtype, device=dev)
        if origin.shape != direction.shape:
            raise ValueError(
                f"origin {tuple(origin.shape)} and direction "
                f"{tuple(direction.shape)} must match")
        norm = torch.sqrt(torch.sum(direction * direction, dim=-1, keepdim=True))
        direction = direction / norm
        return Ray(origin, direction, 1.0 / direction)

    def take(self, idx: torch.Tensor) -> "Ray":
        """The rays at ``idx`` along the batch axis."""
        return Ray(self.origin[idx], self.direction[idx], self.inv_direction[idx])

    def at(self, t: torch.Tensor) -> torch.Tensor:
        """The points ``origin + direction * t``."""
        return self.origin + self.direction * t[..., None]


class Intersection(NamedTuple):
    """Result of a ray-triangle test; ``distance`` is +inf on a miss."""

    distance: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


def _slab(ray: Ray, aabb_min, aabb_max):
    lbr = (aabb_min - ray.origin) * ray.inv_direction
    rtr = (aabb_max - ray.origin) * ray.inv_direction
    has_nan = torch.any(torch.isnan(lbr) | torch.isnan(rtr), dim=-1)
    inf = torch.minimum(lbr, rtr)
    sup = torch.maximum(lbr, rtr)
    return has_nan, inf.amax(dim=-1), sup.amin(dim=-1)


def ray_intersects_aabb(ray: Ray, aabb_min, aabb_max) -> torch.Tensor:
    """Branchless slab test; True where the ray hits the box. NaN in any
    corner product is a miss (a ray lying in a face plane)."""
    has_nan, tmin, tmax = _slab(ray, aabb_min, aabb_max)
    return ~has_nan & (tmax >= torch.clamp_min(tmin, 0.0))


def intersection_slice_for_aabb(ray: Ray, aabb_min, aabb_max):
    """``(hit, t_entry, t_exit)`` of a ray against a box; where ``hit`` is
    False the distances are meaningless (tmin clamped to 0)."""
    has_nan, tmin, tmax = _slab(ray, aabb_min, aabb_max)
    tmin = torch.clamp_min(tmin, 0.0)
    return ~has_nan & (tmin <= tmax), tmin, tmax


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis; each product and difference is its own
    rounded op, so no device fuses them into an FMA."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b over the last axis, summed (x + y) + z on every device."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _moller_trumbore(ray: Ray, a, b, c):
    """Moller-Trumbore's terms without its rejections: ``(cull, u, v,
    dist, eps)``, ``cull`` where det < eps (u, v and dist are finite there
    and meaningless), eps the dtype's machine epsilon."""
    a_to_b = b - a
    a_to_c = c - a
    u_vec = _cross(ray.direction, a_to_c)
    det = _dot(a_to_b, u_vec)
    eps = torch.finfo(det.dtype).eps

    cull = det < eps
    # culled lanes never use inv_det's value; the guard keeps inf*0 NaNs
    # out of the (u, v) report
    inv_det = 1.0 / torch.where(cull, torch.ones_like(det), det)

    a_to_origin = ray.origin - a
    u = _dot(a_to_origin, u_vec) * inv_det
    v_vec = _cross(a_to_origin, a_to_b)
    v = _dot(ray.direction, v_vec) * inv_det
    dist = _dot(a_to_c, v_vec) * inv_det
    return cull, u, v, dist, eps


def ray_intersects_triangle(ray: Ray, a, b, c) -> Intersection:
    """Batched Moller-Trumbore with backface culling (3-D only; float32 or
    float64, eps the dtype's machine epsilon).

    The selects mirror the reference's branches: ``det < eps`` => miss with
    (u, v) = (0, 0); u out of [0, 1] => miss with v = 0; v < 0 or
    u + v > 1 => miss; dist <= eps => miss. Distance is +inf on every miss.
    """
    cull, u, v, dist, eps = _moller_trumbore(ray, a, b, c)
    u_bad = (u < 0.0) | (u > 1.0)
    v_bad = (v < 0.0) | (u + v > 1.0)
    miss = cull | u_bad | v_bad | (dist <= eps)
    distance = torch.where(miss, torch.full_like(dist, float("inf")), dist)
    zero = torch.zeros_like(u)
    return Intersection(distance, torch.where(cull, zero, u),
                        torch.where(cull | u_bad, zero, v))
