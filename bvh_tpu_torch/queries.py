"""Queries that drive a BVH traversal: anything that tests itself against a
node's box.

Counterpart of ``bvh_tpu/queries.py``. A query is a ``NamedTuple`` of
tensors (possibly nested) with a method ``intersects_node(node_min,
node_max) -> bool tensor``, the node tensors broadcasting against the
query's batch; ``bvh/traverse.py::traverse`` is written once against it.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol

import torch

from .aabb import Aabb
from .ball import Ball
from .ray import Ray, ray_intersects_aabb


class Query(Protocol):
    def intersects_node(self, node_min: torch.Tensor,
                        node_max: torch.Tensor) -> torch.Tensor: ...


class RayQuery(NamedTuple):
    """The shapes whose boxes a ray's slab test passes."""

    ray: Ray

    def intersects_node(self, node_min, node_max):
        return ray_intersects_aabb(self.ray, node_min, node_max)


class AabbQuery(NamedTuple):
    """The shapes whose boxes overlap a query box."""

    aabb: Aabb

    def intersects_node(self, node_min, node_max):
        separated = (self.aabb.max < node_min) | (node_max < self.aabb.min)
        return ~torch.any(separated, dim=-1)


class PointQuery(NamedTuple):
    """The shapes whose boxes contain a point."""

    point: torch.Tensor  # [..., D]

    def intersects_node(self, node_min, node_max):
        return torch.all((self.point >= node_min) & (self.point <= node_max),
                         dim=-1)


class BallQuery(NamedTuple):
    """The shapes whose boxes touch a ball."""

    ball: Ball

    def intersects_node(self, node_min, node_max):
        return self.ball.intersects_aabb(node_min, node_max)
