"""The port's trace and nearest-triangle paths: host scene tables, the
coherence sorts, and the hand-written CUDA kernels (group walk, sweep gate,
the two nearest walks) with their plain PyTorch versions."""

from .cluster import (TightScene, build_tight_scene, build_wide_table,
                      collapse_upper, scene_from_arrays)
from .nearest import (nearest_entry_exit, nearest_entry_exit_plain,
                      nearest_tight, nearest_wide, nearest_wide_plain,
                      sort_points_device)
from .sweep import sweep_gate, sweep_gate_plain
from .trace import make_tracer, sort_rays_device, trace_closest_hit_tight
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
    "scene_from_arrays",
    "sort_points_device",
    "sort_rays_device",
    "sweep_gate",
    "sweep_gate_plain",
    "trace_closest_hit_tight",
    "wide_trace",
    "wide_trace_plain",
]
