"""Multi-card scaling on torch.distributed: the ('rays', 'scene') mesh,
ray-sharded traces over a replicated scene, scene-sharded depth rendering
and its training step, and the scaling report.

Counterpart of ``bvh_tpu/parallel``. The axes:

* ``rays``: data parallelism over the query batch (each rank traces a
  chunk);
* ``scene``: range sharding of the primitives: each rank holds a triangle
  range and a BVH over it; closest hits are min-reduced over the axis.

One process drives one card (``torchrun``, NCCL); on the CPU the same code
runs under gloo. Vertex gradients are summed over the rays axis outside
autograd.
"""

from .mesh import init_distributed, make_mesh, make_multihost_mesh
from .scaling import ray_scaling_report
from .shard import (shard_scene, sharded_loss_and_grads, sharded_render_depth,
                    sharded_train_step)
from .tight import (multihost_trace_closest_hit, sharded_trace_any_hit,
                    sharded_trace_closest_hit)

__all__ = [
    "make_mesh",
    "make_multihost_mesh",
    "init_distributed",
    "ray_scaling_report",
    "shard_scene",
    "sharded_render_depth",
    "sharded_loss_and_grads",
    "sharded_train_step",
    "multihost_trace_closest_hit",
    "sharded_trace_closest_hit",
    "sharded_trace_any_hit",
]
