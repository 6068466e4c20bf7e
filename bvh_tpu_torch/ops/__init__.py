"""The port's trace and nearest-triangle paths: host scene tables, the
coherence sorts, and the hand-written CUDA kernels (group walk, entry/exit
walk, sweep gate, the two nearest walks) with their plain PyTorch
versions."""

from .cluster import (TightScene, build_tight_scene, build_wide_table,
                      collapse_upper, pack_node_table_bf16, scene_from_arrays,
                      unpack_node_table_bf16)
from .nearest import (nearest_entry_exit, nearest_entry_exit_plain,
                      nearest_tight, nearest_wide, nearest_wide_plain,
                      sort_points_device)
from .sweep import sweep_gate, sweep_gate_plain
from .tight import tight_trace, tight_trace_plain
from .trace import (make_tracer, sort_rays_device, trace_any_hit_tight,
                    trace_closest_hit_tight)
from .wide import wide_trace, wide_trace_plain

__all__ = [
    "TightScene",
    "build_tight_scene",
    "build_wide_table",
    "collapse_upper",
    "make_tracer",
    "nearest_entry_exit",
    "nearest_entry_exit_plain",
    "nearest_tight",
    "nearest_wide",
    "nearest_wide_plain",
    "pack_node_table_bf16",
    "scene_from_arrays",
    "sort_points_device",
    "sort_rays_device",
    "sweep_gate",
    "sweep_gate_plain",
    "tight_trace",
    "tight_trace_plain",
    "trace_any_hit_tight",
    "trace_closest_hit_tight",
    "unpack_node_table_bf16",
    "wide_trace",
    "wide_trace_plain",
]
