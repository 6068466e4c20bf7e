"""IO: persistence of the acceleration structures and mesh loading, in
the JAX package's file formats (``bvh_tpu/io``)."""

from .obj import load_obj_triangles
from .serialize import (
    load_bvh,
    load_chained_scene,
    load_cluster_scene,
    load_tight_scene,
    save_bvh,
    save_chained_scene,
    save_cluster_scene,
    save_tight_scene,
)

__all__ = [
    "save_bvh",
    "load_bvh",
    "save_cluster_scene",
    "load_cluster_scene",
    "save_tight_scene",
    "load_tight_scene",
    "save_chained_scene",
    "load_chained_scene",
    "load_obj_triangles",
]
