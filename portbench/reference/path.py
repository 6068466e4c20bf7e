"""The path tracer by brute force: the renderer's waves, glue and shading in
plain PyTorch, over a handful of pixels.

It follows ``bvh_tpu_torch/render.py::make_pathtracer`` step by step: a
closest-hit wave, its hit frames (the hit point ``o + normalize(d) t`` and
the winning triangle's unit normal, turned to face the ray), a next-event
shadow ray from the hit point lifted 1e-3 along that normal to the point
light, answered by any hit before 0.999 of the light's distance, the sky
where a live ray misses, Lambert shading with ``light_power / max(dist,
1)**2`` falloff where the light is seen, and the next ray from the hit
point along ``normalize(normal + u)``, ``u`` the bounce's normal noise
normalized and turned into the normal's hemisphere. Dead lanes are parked
at origin 2e30 with direction (1, 1, 1), as the renderer parks them.

The hits are ``hits.closest_hits``'s (every ray against every triangle, by
the tracer's rules); an any hit below ``t_max`` is a closest hit below it.
The one departure from the renderer is the precision: everything is
computed in ``dtype`` (float64 by default), where the renderer computes in
float32 and its walks prune in their own frames. It imports nothing of the
program under test.
"""

from __future__ import annotations

import torch

from portbench.reference import hits

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PARK = 2.0e30  # the origin of a dead lane
LIFT = 1e-3  # how far a secondary ray starts off its surface
SHADOW_REACH = 0.999  # a shadow ray's t_max, in units of the light's distance
WAVE = 8  # per-pixel tensors a wave: o, d, t, id, shadow o, shadow d, dist, occluded


def normalize(v, eps: float = 1e-20):
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1,
                                                        keepdim=True), eps)


def occluded(o, d, t_max, tris, dtype=torch.float64):
    """Whether each ray hits a triangle at t < ``t_max`` (its own)."""
    t, _ = hits.closest_hits(o, d, tris, dtype=dtype)
    return t < t_max.to(t.dtype)


def hit_frames(o, d, t, ids, tris, dtype=torch.float64):
    """Per ray of a closest-hit wave: whether it hit, the hit point (``o``
    where it missed) and the winning triangle's unit normal facing the
    ray, in ``dtype``."""
    o, d, t = o.to(dtype), d.to(dtype), t.to(dtype)
    found = torch.isfinite(t)
    p = o + normalize(d) * torch.where(found, t, 0.0)[:, None]
    a, b, c = (x.to(dtype)[ids.clamp_min(0).long()] for x in tris)
    nrm = normalize(torch.linalg.cross(b - a, c - a))
    nrm = torch.where((torch.sum(nrm * d, -1) > 0)[:, None], -nrm, nrm)
    return found, p, nrm


def shadow_rays(p, nrm, live, light):
    """Origins (dead lanes parked), unit directions and distances of the
    shadow rays from ``p`` to ``light``."""
    to_l = light[None] - p
    dist = torch.linalg.vector_norm(to_l, dim=-1)
    wl = to_l / torch.clamp_min(dist[:, None], 1e-20)
    return torch.where(live[:, None], p + nrm * LIFT, PARK), wl, dist


def next_rays(p, nrm, live, noise):
    """The bounce rays from ``p`` (dead lanes parked) for the noise
    ``noise`` [S, 3]."""
    u = normalize(noise.to(p.dtype))
    u = torch.where(torch.sum(u * nrm, -1, keepdim=True) < 0, -u, u)
    return (torch.where(live[:, None], p + nrm * LIFT, PARK),
            torch.where(live[:, None], normalize(nrm + u), 1.0))


def shade(color, throughput, found, alive, nrm, wl, dist, occ, shading,
          full=False):
    """One wave's colour: the sky where a live ray missed, the light where
    a live hit sees it; and the throughput after the bounce. ``full``: the
    light term at full incidence wherever a live ray hit, the scale that a
    colour's error is read against."""
    sky, al, lc = (torch.as_tensor(shading[k], dtype=color.dtype,
                                   device=color.device)
                   for k in ("sky", "albedo", "light_col"))
    hitm = found & alive
    color = color + torch.where((~found & alive)[:, None], throughput * sky,
                                0.0)
    ndl = torch.clamp_min(torch.sum(nrm * wl, -1), 0.0)
    lit = hitm if full else hitm & ~occ
    falloff = shading["light_power"] / torch.clamp_min(dist, 1.0) ** 2
    color = color + torch.where(
        lit[:, None],
        throughput * al * lc * ((1.0 if full else ndl) * falloff)[:, None],
        0.0)
    return color, torch.where(hitm[:, None], throughput * al, throughput)


def render(o, d, noise, tris, shading: dict, dtype=torch.float64):
    """The path tracer over the pixels ``o``, ``d`` ([S, 3]) with the bounce
    noise ``noise`` ([S, bounces, 3]), every wave by brute force in
    ``dtype``: ``(color, *waves)`` in the renderer's ``waves=True`` form.
    ``shading``: ``light_pos``, ``light_col``, ``sky``, ``albedo``,
    ``light_power``."""
    bounces = noise.shape[1]
    light = torch.as_tensor(shading["light_pos"], dtype=dtype,
                            device=o.device)
    o, d = o.to(dtype), d.to(dtype)
    color = torch.zeros_like(o)
    throughput = torch.ones_like(o)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    out = []
    for k in range(bounces + 1):
        t, ids = hits.closest_hits(o, d, tris, dtype=dtype)
        found, p, nrm = hit_frames(o, d, t, ids, tris, dtype)
        hitm = found & alive
        sh_o, wl, dist = shadow_rays(p, nrm, hitm, light)
        occ = occluded(sh_o, wl, dist * SHADOW_REACH, tris, dtype)
        out += [o, d, t, ids, sh_o, wl, dist, occ]
        color, throughput = shade(color, throughput, found, alive, nrm, wl,
                                  dist, occ, shading)
        alive = hitm
        if k < bounces:
            o, d = next_rays(p, nrm, alive, noise[:, k])
    return (color, *out)
