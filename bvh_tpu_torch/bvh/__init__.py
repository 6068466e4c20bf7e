"""BVH construction (host SAH, LBVH on tensors), refit and traversal
records."""

from .flat import LEAF, FlatBvh
from .lbvh import build_lbvh, morton_codes
from .refit import refit, update_shapes
from .sah_build import build_sah
from .traverse import HitRecord

__all__ = ["FlatBvh", "LEAF", "HitRecord", "build_lbvh", "build_sah",
           "morton_codes", "refit", "update_shapes"]
