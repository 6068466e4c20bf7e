"""Scaling efficiency: rays/s of the ray-sharded trace against its rank
count.

Counterpart of ``bvh_tpu/parallel/scaling.py``. The scene is replicated
and the traversal has no traffic between ranks (``parallel/tight.py``),
so efficiency should stay near 1.0 until a rank's chunk is too small to
fill its card. On the CPU under gloo (the tests) the numbers are
meaningless; the harness, meshes and collectives are exercised.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..ray import Ray
from .mesh import ensure_group, make_mesh, mesh_device
from .tight import sharded_trace_closest_hit


def ray_scaling_report(scene, rays: Ray, shard_counts=(1, 2, 4, 8),
                       packet: int = 2048, iters: int = 3,
                       time_fn=time.perf_counter, device=None) -> dict:
    """Times the ray-sharded trace on the first n ranks for each n of
    ``shard_counts`` (n above the world size skipped). Every rank of the
    world calls it with the same arguments; ranks outside a sub-mesh wait
    at the collective that ends its n.

    Returns ``{n: {"rays_per_s": float, "efficiency": float}}``, the same
    on every rank: a time is the best of ``iters`` runs after a warm-up
    (fenced with ``torch.cuda.synchronize()`` on the card), the slowest
    rank's; efficiency is rays/s relative to linear scaling from the
    smallest n measured. ``device``: as ``make_mesh``'s."""
    r = rays.origin.shape[0]
    report = {}
    base_n = base_rps = None
    world = ensure_group(device)
    for n in shard_counts:
        if n > world:
            continue
        mesh = make_mesh(n, scene_shards=1, device=device)
        dev = mesh_device(mesh)
        best = torch.zeros((), dtype=torch.float64, device=dev)
        if mesh.get_coordinate() is not None:

            def run():
                sharded_trace_closest_hit(mesh, scene, rays, packet=packet)
                if dev.type == "cuda":
                    torch.cuda.synchronize()

            run()  # warm-up (first launches build and load the kernels)
            times = []
            for _ in range(max(iters, 1)):
                t0 = time_fn()
                run()
                times.append(time_fn() - t0)
            best.fill_(min(times))
        # the slowest rank's time, on every rank (the outsiders wait here)
        dist.all_reduce(best, op=dist.ReduceOp.MAX)
        rps = r / float(best)
        if base_rps is None:
            base_n, base_rps = n, rps
        report[n] = {"rays_per_s": rps,
                     "efficiency": rps / (base_rps * n / base_n)}
    return report
