"""Scene-sharded depth rendering and the training step on a ('rays',
'scene') mesh.

Counterpart of ``bvh_tpu/parallel/shard.py``:

* rays are sharded over the rays axis (data parallelism);
* the scene is range-sharded over the scene axis: shard s holds a
  contiguous triangle range and a BVH built over just that range
  (``shard_scene``). Each rank walks its rays against its shard with the
  general path (``bvh/traverse.py::closest_hit_triangles``), recomputes
  the hit on the winning triangle, and the closest hit over the scene axis
  is taken from an all_gather of the shards' distances (S values a ray);
* vertex gradients stay with their shard; they are summed over the rays
  axis, outside autograd.

Every rank of the mesh passes the same global arguments and gets the
whole result back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..bvh.flat import FlatBvh
from ..bvh.sah_build import build_sah
from ..bvh.traverse import closest_hit_triangles
from ..ray import Ray, ray_intersects_triangle
from .mesh import axis, gather, mesh_device


def shard_scene(tri_a, tri_b, tri_c, n_shards: int):
    """Host-side: split triangles into ``n_shards`` contiguous ranges and
    build one BVH per range. Returns stacked arrays with a leading shard
    axis (equal node counts, so they stack) plus the stacked triangle
    ranges, numpy.

    Requires the triangle count to be divisible by ``n_shards``.
    """
    n = tri_a.shape[0]
    if n % n_shards:
        raise ValueError(f"{n} triangles not divisible by {n_shards} shards")
    k = n // n_shards
    flats = []
    for s in range(n_shards):
        sl = slice(s * k, (s + 1) * k)
        mn = np.minimum(np.minimum(tri_a[sl], tri_b[sl]), tri_c[sl])
        mx = np.maximum(np.maximum(tri_a[sl], tri_b[sl]), tri_c[sl])
        flat, _ = build_sah(mn, mx)
        flats.append(flat)
    stacked = FlatBvh(*(np.stack([np.asarray(getattr(f, n_)) for f in flats])
                        for n_ in FlatBvh._fields))
    a = np.stack([tri_a[s * k:(s + 1) * k] for s in range(n_shards)])
    b = np.stack([tri_b[s * k:(s + 1) * k] for s in range(n_shards)])
    c = np.stack([tri_c[s * k:(s + 1) * k] for s in range(n_shards)])
    return stacked, a, b, c


def _local(mesh, flat, tris, rays: Ray, *per_ray):
    """This rank's part: its scene shard (the flat tree and the stacked
    triangle tables ``tris``, as tensors on its device) and its chunk of
    the rays and of each of ``per_ray``. Raises where the scene axis is not
    the shard count or the rays axis does not divide the ray count."""
    n_sc, s, _ = axis(mesh, "scene")
    n_ax, i, _ = axis(mesh, "rays")
    dev = mesh_device(mesh)
    if flat.entry.shape[0] != n_sc:
        raise ValueError(f"{flat.entry.shape[0]} scene shards on a mesh of "
                         f"{n_sc} along 'scene'")
    r = rays.origin.shape[0]
    if r % n_ax:
        raise ValueError(f"{r} rays not divisible by the {n_ax} ranks of "
                         "the 'rays' axis")
    m = r // n_ax
    part = slice(i * m, (i + 1) * m)
    flat_s = FlatBvh(*(torch.as_tensor(x[s]).to(dev) for x in flat))
    tris_s = tuple(torch.as_tensor(x[s]).to(dev) for x in tris)
    rays_c = Ray(*(torch.as_tensor(x).to(dev)[part] for x in rays))
    return (flat_s, tris_s, rays_c,
            *(torch.as_tensor(x).to(dev)[part] for x in per_ray))


def _closest(mesh, flat, a, b, c, rays: Ray):
    """The shard's closest hit, recomputed on its triangle (differentiable
    in ``a``, ``b``, ``c``), and the scene axis' verdict: ``(t_loc, sid,
    won, tmin, winner)``, ``won`` where this shard holds the closest hit
    (the first shard on a tie)."""
    _, rank, group = axis(mesh, "scene")
    with torch.no_grad():
        hard = closest_hit_triangles(flat, Ray(*(x.detach() for x in rays)),
                                     a.detach(), b.detach(), c.detach())
    sid = hard.shape_id
    g9 = torch.cat([a, b, c], dim=1)[sid.clamp_min(0).long()]
    inter = ray_intersects_triangle(rays, g9[:, 0:3], g9[:, 3:6], g9[:, 6:9])
    t_loc = torch.where(sid >= 0, inter.distance, float("inf"))
    ts = gather(t_loc.detach(), group)  # [S, r] hit distances
    tmin, winner = ts.min(dim=0)
    won = (winner == rank) & (sid >= 0)
    return t_loc, sid, won, tmin, winner


def sharded_render_depth(mesh, flat, a, b, c, rays: Ray,
                         background: float = 0.0):
    """Depth image over a ('rays', 'scene') mesh: ``(depth, gid)`` [R],
    ``background`` and -1 on a miss. ``flat`` and ``a``, ``b``, ``c``
    carry a leading scene-shard axis (``shard_scene``); ``rays`` is the
    global [R, 3] batch, R divisible by the rays axis."""
    flat_s, (a_s, b_s, c_s), rays_c = _local(mesh, flat, (a, b, c), rays)
    _, rank, group = axis(mesh, "scene")
    t_loc, sid, _, tmin, winner = _closest(mesh, flat_s, a_s, b_s, c_s,
                                           rays_c)
    # the winner's shape id, in the whole scene's numbering
    k = a_s.shape[0]
    gids = gather(torch.where(sid >= 0, sid.long() + rank * k, -1), group)
    gid = gids.gather(0, winner[None]).reshape(-1)
    hit = torch.isfinite(tmin)
    depth = torch.where(hit, tmin, background)
    gid = torch.where(hit, gid, -1).to(torch.int32)
    _, _, rays_group = axis(mesh, "rays")
    return (gather(depth, rays_group).reshape(-1),
            gather(gid, rays_group).reshape(-1))


def sharded_loss_and_grads(mesh, verts, flat, rays: Ray, target,
                           background: float = 0.0):
    """Global mean-squared depth loss against ``target`` [R] and its
    vertex gradients, ``(loss, (ga, gb, gc))``: ``verts`` is ``(a, b, c)``
    [S, k, 3] as ``shard_scene`` stacks them, and the gradients have their
    shapes (summed over the rays axis, gathered over the scene axis).

    No collective is differentiated: the local loss is the squared error
    of the residuals this rank owns (its rays where its shard holds the
    closest hit, and, on scene rank 0, its rays that hit nothing), so the
    sum of the local losses over the mesh is the global sum; its gradient
    is taken locally, then summed over the rays axis."""
    n_total = target.shape[0]
    flat_s, tris_s, rays_c, target_c = _local(mesh, flat, verts, rays,
                                              target)
    tris_s = tuple(x.detach().requires_grad_(True) for x in tris_s)
    _, rank, scene_group = axis(mesh, "scene")
    _, _, rays_group = axis(mesh, "rays")
    t_loc, _, won, tmin, _ = _closest(mesh, flat_s, *tris_s, rays_c)
    res_won = torch.where(won, t_loc - target_c, 0.0)
    miss = ~torch.isfinite(tmin) & (rank == 0)
    res_miss = torch.where(miss, background - target_c, 0.0)
    lval = (res_won * res_won).sum() + (res_miss * res_miss).sum()
    grads = torch.autograd.grad(lval, tris_s)
    loss = lval.detach()
    dist.all_reduce(loss, group=rays_group)
    dist.all_reduce(loss, group=scene_group)
    out = []
    for g in grads:
        g = g.contiguous()
        dist.all_reduce(g, group=rays_group)
        out.append(gather(g / n_total, scene_group))
    return loss / n_total, tuple(out)


def sharded_train_step(mesh, verts, flat, rays: Ray, target,
                       lr: float = 1e-2, background: float = 0.0):
    """One SGD step fitting triangle vertices to a target depth image:
    ``(loss, (a, b, c))`` with each table ``v - lr * g``. The forward pass
    is the sharded depth pass; the gradients flow through the analytic hit
    recompute and are summed over the rays axis (the data-parallel
    all-reduce)."""
    loss, grads = sharded_loss_and_grads(mesh, verts, flat, rays, target,
                                         background)
    dev = grads[0].device
    return loss, tuple(torch.as_tensor(v).to(dev) - lr * g
                       for v, g in zip(verts, grads))
