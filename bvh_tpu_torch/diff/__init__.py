"""Differentiable closest-hit rendering: gradients of hit distance and
barycentrics with respect to triangle vertices and ray origins and
directions. Counterpart of ``bvh_tpu/diff``."""

from .camera import camera_rays
from .render import (render_depth, render_depth_fast, render_hits,
                     render_hits_fast)

__all__ = ["camera_rays", "render_depth", "render_depth_fast", "render_hits",
           "render_hits_fast"]
