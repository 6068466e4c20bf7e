"""Differentiable closest-hit rendering over a ``FlatBvh`` or a
``TightScene``.

Counterpart of ``bvh_tpu/diff/render.py``: ``render_hits`` and
``render_depth`` walk the general path (``bvh/traverse.py::
closest_hit_triangles``), ``render_hits_fast`` and ``render_depth_fast``
the card's kernels (``ops/trace.py::trace_closest_hit_tight``). The walk
only picks which triangle each ray hits, so it runs without gradients; the
hit's (t, u, v) is then recomputed on the winning triangle with
Moller-Trumbore in plain tensor operations, and autograd differentiates
that: gradients hold the hit topology fixed, the usual convention away
from visibility edges. No backward kernel is needed; the backward of the
winner gather is a scatter-add into the vertex tables.
"""

from __future__ import annotations

import torch

from ..bvh.flat import FlatBvh
from ..bvh.traverse import HitRecord, closest_hit_triangles
from ..ops.trace import trace_closest_hit_tight
from ..ray import Ray, _moller_trumbore, ray_intersects_triangle


def render_hits(flat: FlatBvh, rays: Ray, tri_a, tri_b, tri_c) -> HitRecord:
    """The closest hit over ``flat`` (built over the triangles' boxes)
    with ``t``, ``u`` and ``v`` differentiable with respect to the vertex
    tables ``tri_*`` [n_tris, 3] and the rays; ``shape_id`` carries no
    gradient. The walk runs on detached copies in the inputs' dtype and on
    their device; a miss has ``t`` = +inf, ``u`` = ``v`` = 0 and gives no
    gradient."""
    with torch.no_grad():
        hard = closest_hit_triangles(flat, Ray(*(x.detach() for x in rays)),
                                     tri_a.detach(), tri_b.detach(),
                                     tri_c.detach())
    sid = hard.shape_id
    g9 = torch.cat([tri_a, tri_b, tri_c], dim=1)[sid.clamp_min(0).long()]
    inter = ray_intersects_triangle(rays, g9[:, 0:3], g9[:, 3:6], g9[:, 6:9])
    hit = sid >= 0
    inf = torch.full_like(inter.distance, float("inf"))
    return HitRecord(torch.where(hit, inter.distance, inf),
                     torch.where(hit, inter.u, 0.0),
                     torch.where(hit, inter.v, 0.0), sid)


def render_depth(flat: FlatBvh, rays: Ray, tri_a, tri_b, tri_c,
                 background: float = 0.0):
    """Depth image ``(depth, hit)``: the hit distance, ``background`` on a
    miss, differentiable as in ``render_hits``."""
    h = render_hits(flat, rays, tri_a, tri_b, tri_c)
    hit = h.shape_id >= 0
    return torch.where(hit, h.t, background), hit


def render_hits_fast(scene, rays: Ray, tri_a, tri_b, tri_c, packet: int = 2048,
                     hints=None, start_g=None, device=None) -> HitRecord:
    """Closest hit with ``t``, ``u`` and ``v`` differentiable with respect
    to the vertex tables ``tri_a``, ``tri_b``, ``tri_c`` ([n_tris, 3]) and
    the rays; ``shape_id`` carries no gradient.

    ``scene`` is built over the same triangles. The walk runs on float32
    copies of the rays on ``device`` (None: the card); the recompute runs in
    the dtype and on the device of the inputs. ``hints`` and ``start_g`` as
    in ``trace_closest_hit_tight`` (results do not depend on them). The
    walk decides the hit: its leaf test runs in the scene's exact frame, so
    on a ray that crosses near an edge it takes float64's triangle where
    the recompute, in the inputs' dtype and world coordinates, can put the
    ray a rounding outside that triangle; the hit stays, with the
    recompute's (t, u, v) (u, v or 1 - u - v then a rounding below
    0). Only a
    recompute that culls the triangle (det < eps) or puts it behind the
    origin makes a miss. A miss has ``t`` = +inf, ``u`` = ``v`` = 0 and
    gives no gradient."""
    with torch.no_grad():
        hard = trace_closest_hit_tight(
            scene, Ray(*(x.detach().float() for x in rays)), packet=packet,
            hints=hints, start_g=start_g, device=device)
    sid = hard.shape_id.to(rays.origin.device)
    # one gather of the winners' nine coordinates
    g9 = torch.cat([tri_a, tri_b, tri_c], dim=1)[sid.clamp_min(0).to(torch.int64)]
    cull, u, v, dist, eps = _moller_trumbore(rays, g9[:, 0:3], g9[:, 3:6],
                                             g9[:, 6:9])
    hit = (sid >= 0) & ~cull & (dist.detach() > eps)
    inf = torch.full_like(dist, float("inf"))
    return HitRecord(torch.where(hit, dist, inf),
                     torch.where(hit, u, 0.0),
                     torch.where(hit, v, 0.0),
                     torch.where(hit, sid, -1))


def render_depth_fast(scene, rays: Ray, tri_a, tri_b, tri_c,
                      background: float = 0.0, packet: int = 2048, hints=None,
                      start_g=None, device=None):
    """Depth image ``(depth, hit)``: the hit distance, ``background`` on a
    miss, differentiable as in ``render_hits_fast``."""
    h = render_hits_fast(scene, rays, tri_a, tri_b, tri_c, packet=packet,
                         hints=hints, start_g=start_g, device=device)
    hit = h.shape_id >= 0
    return torch.where(hit, h.t, background), hit
