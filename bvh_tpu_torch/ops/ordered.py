"""The first K triangle hits per ray, nearest first, by depth peeling.

Counterpart of ``bvh_tpu/ops/ordered.py``: trace the closest hit, move each
ray's origin just past it, trace again; every pass is a full closest-hit
trace through the kernels, and from the second pass on packets with no live
ray are gated off (the pre-gate on a tight scene, a zero bound per dead ray
on a chained one).

Documented classes (as in the reference): two surfaces within the peel
epsilon of each other (``eps_rel`` = 1e-4 relative, ``eps_abs`` = 1e-6)
may merge into one reported hit; back faces are culled, so the hits are the
front-facing ones.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ray import Ray
from .trace import trace_closest_hit_chained, trace_closest_hit_tight

_INF = float("inf")


def _peel(rays: Ray, k: int, eps_rel: float, eps_abs: float, trace_pass):
    """The depth-peel loop: ``trace_pass(ray_i, alive, i) -> HitRecord``
    runs pass i; returns ``(t [R, k], shape_id [R, k], count [R])``."""
    o, d, inv = rays
    r = o.shape[0]
    t_off = torch.zeros(r, dtype=torch.float32, device=o.device)
    alive = torch.ones(r, dtype=torch.bool, device=o.device)
    ts, ids = [], []
    for i in range(k):
        hit = trace_pass(Ray(o + t_off[:, None] * d, d, inv), alive, i)
        fin = torch.isfinite(hit.t) & alive
        ts.append(torch.where(fin, t_off + hit.t, _INF))
        ids.append(torch.where(fin, hit.shape_id, -1))
        if i + 1 < k:
            step = hit.t * (1.0 + eps_rel) + eps_abs
            t_off = t_off + torch.where(fin, step, 0.0)
            alive = fin
    t = torch.stack(ts, dim=1)
    return (t, torch.stack(ids, dim=1),
            torch.isfinite(t).sum(dim=1).to(torch.int32))


def _empty(k: int, dev):
    return (torch.zeros((0, k), dtype=torch.float32, device=dev),
            torch.zeros((0, k), dtype=torch.int32, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev))


def _on_device(rays: Ray, tris, dev):
    """The rays and the vertex arrays (if any) as tensors on ``dev``, copied
    once for all passes."""
    rays = Ray(*(x.to(dev) for x in rays))
    if tris is not None:
        tris = tuple(torch.as_tensor(x, dtype=torch.float32, device=dev)
                     for x in tris)
    return rays, tris


def trace_k_closest(scene, rays: Ray, k: int = 4, packet: int = 2048,
                    sweep: bool = False, tris=None, eps_rel: float = 1e-4,
                    eps_abs: float = 1e-6, precision=None, device=None):
    """First ``k`` triangle hits per ray over a ``TightScene``, nearest
    first: ``(t [R, k], shape_id [R, k], count [R])``; unused slots hold
    +inf and -1. ``tris=(a, b, c)``: recompute each winner's exact t (it
    tightens the peel offsets and the distances). ``precision`` is taken for
    call compatibility and changes nothing; ``device``: where to run (None:
    the card)."""
    dev = resolve_device(device)
    r = rays.origin.shape[0]
    if r == 0:
        return _empty(k, dev)
    rays, tris = _on_device(rays, tris, dev)
    p = -(-r // packet)

    def trace_pass(ray_i, alive, i):
        gate = None
        if i > 0:
            al = torch.zeros(p * packet, dtype=torch.bool, device=dev)
            al[:r] = alive
            gate = al.view(p, packet).any(dim=1).to(torch.int32)
        return trace_closest_hit_tight(scene, ray_i, tris=tris, packet=packet,
                                       sweep=sweep, pre_gate=gate, device=dev)

    return _peel(rays, k, eps_rel, eps_abs, trace_pass)


def trace_k_closest_chained(chained, rays: Ray, k: int = 4,
                            packet: int = 2048, sweep: bool = True, tris=None,
                            eps_rel: float = 1e-4, eps_abs: float = 1e-6,
                            device=None):
    """``trace_k_closest`` over a ``ChainedScene``. From the second pass on,
    dead rays carry ``t_max = 0``: the parts' root gates then close packets
    with no live ray, and live packets prune their dead rays at the root."""
    dev = resolve_device(device)
    if rays.origin.shape[0] == 0:
        return _empty(k, dev)
    rays, tris = _on_device(rays, tris, dev)

    def trace_pass(ray_i, alive, i):
        tm = None if i == 0 else torch.where(alive, _INF, 0.0)
        return trace_closest_hit_chained(chained, ray_i, tris=tris,
                                         packet=packet, t_max=tm, sweep=sweep,
                                         device=dev)

    return _peel(rays, k, eps_rel, eps_abs, trace_pass)
