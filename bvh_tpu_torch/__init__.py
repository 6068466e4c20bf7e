"""bvh_tpu_torch — the PyTorch and CUDA port of ``bvh_tpu``.

A second package beside the JAX one: host scene builds stay numpy, boxes,
balls and queries, the general batched traversal of a flat BVH
(``bvh/traverse.py``, ``bvh/ordered.py``, PyTorch operations), the
closest-hit, any-hit and k-closest traces (tight, chained and legacy
cluster scenes), the path tracer (``render.py``) and the nearest-triangle
queries run on an NVIDIA card through hand-written CUDA kernels (built
from ``bvh_tpu_torch/csrc`` at first use),
and every kernel has a plain PyTorch version that runs on the CPU. Entry points run on the card unless the
caller passes ``device="cpu"``. The package imports neither JAX nor
anything of ``bvh_tpu``.
"""

from .aabb import Aabb
from .ball import Ball, Circle, Sphere
from .config import DEFAULT_CONFIG, BvhConfig
from .device import resolve_device
from .queries import AabbQuery, BallQuery, PointQuery, RayQuery
from .ray import (Intersection, Ray, intersection_slice_for_aabb,
                  ray_intersects_aabb, ray_intersects_triangle)
from .tri import closest_point_on_triangle, point_triangle_distance_squared

__version__ = "0.1.0"

__all__ = [
    "Aabb",
    "AabbQuery",
    "Ball",
    "BallQuery",
    "BvhConfig",
    "Circle",
    "DEFAULT_CONFIG",
    "Intersection",
    "PointQuery",
    "Ray",
    "RayQuery",
    "closest_point_on_triangle",
    "intersection_slice_for_aabb",
    "point_triangle_distance_squared",
    "ray_intersects_aabb",
    "ray_intersects_triangle",
    "resolve_device",
    "Sphere",
]
