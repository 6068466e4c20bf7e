"""The port's trace and nearest-triangle paths: host scene tables (tight,
legacy cluster and chained scenes), scene builds, refits and mask+delta
updates on the device, the coherence sorts, and the hand-written CUDA
kernels (group walk, entry/exit walk, sweep gate, legacy cluster walk, the
two nearest walks, the closest-hit epilogue, and the slab count of
bench.py's ray_aabb_1000 leg)
with their plain PyTorch versions and counting builds (the visit
counters), and the seeders and subtree-entry planners of the group walk,
and the scene validators.
The legacy walk's wrapper is ``ops.cluster_trace.cluster_trace``: the
module keeps the name, so the package does not re-export the function."""

from .cluster import (ChainedScene, ClusterScene, TightScene,
                      build_chained_scene, build_cluster_scene,
                      build_tight_scene, build_wide_table,
                      chained_scene_from_parts, cluster_scene_from_arrays,
                      collapse_upper, pack_node_table_bf16, scene_from_arrays,
                      unpack_node_table_bf16)
from .device_build import (build_chained_scene_device,
                           build_tight_scene_device, make_refitter)
from .nearest import (count_visits_nearest, nearest_chained, nearest_entry_exit,
                      nearest_entry_exit_plain, nearest_seed,
                      nearest_seed_plain, nearest_tight, nearest_wide,
                      nearest_wide_plain, sort_points_device)
from .ordered import trace_k_closest, trace_k_closest_chained
from .slab import slab_count, slab_count_plain
from .sweep import sweep_gate, sweep_gate_plain
from .tight import tight_trace, tight_trace_plain
from .trace import (compute_seed_hints, count_visits_tight,
                    count_visits_wide, make_key_planner, make_planner,
                    make_seeder, make_tracer, sort_rays, sort_rays_device,
                    trace_any_hit_chained, trace_any_hit_tight,
                    trace_closest_hit, trace_closest_hit_chained,
                    trace_closest_hit_seeded, trace_closest_hit_tight)
from .update import make_chained_updater, make_updater
from .validate_scene import assert_tight_scene, check_tight_scene
from .wide import wide_trace, wide_trace_plain

__all__ = [
    "ChainedScene",
    "ClusterScene",
    "TightScene",
    "assert_tight_scene",
    "build_chained_scene",
    "build_chained_scene_device",
    "build_cluster_scene",
    "build_tight_scene",
    "build_tight_scene_device",
    "build_wide_table",
    "chained_scene_from_parts",
    "check_tight_scene",
    "cluster_scene_from_arrays",
    "collapse_upper",
    "compute_seed_hints",
    "count_visits_nearest",
    "count_visits_tight",
    "count_visits_wide",
    "make_chained_updater",
    "make_key_planner",
    "make_planner",
    "make_refitter",
    "make_seeder",
    "make_tracer",
    "make_updater",
    "nearest_chained",
    "nearest_entry_exit",
    "nearest_entry_exit_plain",
    "nearest_seed",
    "nearest_seed_plain",
    "nearest_tight",
    "nearest_wide",
    "nearest_wide_plain",
    "pack_node_table_bf16",
    "scene_from_arrays",
    "slab_count",
    "slab_count_plain",
    "sort_points_device",
    "sort_rays",
    "sort_rays_device",
    "sweep_gate",
    "sweep_gate_plain",
    "tight_trace",
    "tight_trace_plain",
    "trace_any_hit_chained",
    "trace_any_hit_tight",
    "trace_closest_hit",
    "trace_closest_hit_chained",
    "trace_closest_hit_seeded",
    "trace_closest_hit_tight",
    "trace_k_closest",
    "trace_k_closest_chained",
    "unpack_node_table_bf16",
    "wide_trace",
    "wide_trace_plain",
]
