"""BVH construction (host SAH, LBVH on tensors), the host pointer tree,
refit, the general batched traversal and its records, and the validators."""

from .flat import LEAF, FlatBvh
from .lbvh import build_lbvh, morton_codes
from .ordered import farthest_traverse, nearest_traverse, ordered_traverse
from .refit import refit, update_shapes
from .sah_build import build_sah
from .traverse import (HitRecord, any_hit_triangles, brute_force_closest_hit,
                       brute_force_collect, closest_hit_chunked,
                       closest_hit_triangles, nearest_to,
                       nearest_to_triangles, traverse, traverse_all)
from .tree import Bvh
from .validate import (assert_consistent, assert_tight, check_consistent,
                       check_tight)

__all__ = ["FlatBvh", "LEAF", "Bvh", "HitRecord", "any_hit_triangles",
           "assert_consistent", "assert_tight", "brute_force_closest_hit",
           "brute_force_collect", "build_lbvh", "build_sah",
           "check_consistent", "check_tight", "closest_hit_chunked",
           "closest_hit_triangles", "farthest_traverse", "morton_codes",
           "nearest_to", "nearest_to_triangles", "nearest_traverse",
           "ordered_traverse", "refit", "traverse", "traverse_all",
           "update_shapes"]
