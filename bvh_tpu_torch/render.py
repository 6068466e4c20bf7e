"""Wavefront path tracing over a ``TightScene``: closest-hit waves, next-event
shadow waves to a point light, and Lambertian bounces.

Counterpart of ``bvh_tpu/render.py::make_pathtracer``. Each frame runs
``bounces + 1`` closest-hit waves and ``bounces + 1`` shadow waves through
the port's trace kernels; everything between them is elementwise PyTorch on
the same device. Dead lanes are parked at origin 2e30, where they miss at
the root, rather than compacted, and bounce waves are not re-sorted: they
inherit the primary tiles' image-space coherence. The primary wave runs
without the sweep gate, every bounce and shadow wave with it, as in the
reference. The bounce noise is ``[npx, 3]`` standard normals from the
caller's ``torch.Generator``, one draw per bounce (``bounce_noise``); it is
not the JAX key's stream.
"""

from __future__ import annotations

import torch

from .device import resolve_device
from .ops.trace import trace_any_hit_tight, trace_closest_hit_tight
from .ray import Ray

_PARK = 2.0e30  # origin of a dead lane: it misses at the root


def _normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                               eps)


def bounce_noise(npx: int, generator: torch.Generator, device) -> torch.Tensor:
    """One bounce's noise: [npx, 3] float32 standard normals."""
    return torch.randn((npx, 3), generator=generator, dtype=torch.float32,
                       device=device)


def hit_frames(hit, o: torch.Tensor, d: torch.Tensor, v9: torch.Tensor):
    """Per ray of a closest-hit wave: whether it hit, the hit point
    ``o + normalize(d)·t`` (``o`` where it missed) and the unit normal of
    the winning triangle facing the ray."""
    found = torch.isfinite(hit.t)
    t_safe = torch.where(found, hit.t, 0.0)
    p = o + _normalize(d) * t_safe[:, None]
    g9 = v9[hit.shape_id.clamp_min(0).to(torch.int64)]
    nrm = _normalize(torch.linalg.cross(g9[:, 3:6] - g9[:, 0:3],
                                        g9[:, 6:9] - g9[:, 0:3]))
    nrm = torch.where((torch.sum(nrm * d, -1) > 0)[:, None], -nrm, nrm)
    return found, p, nrm


def shadow_rays(p: torch.Tensor, nrm: torch.Tensor, live: torch.Tensor,
                light_pos: torch.Tensor):
    """Next-event shadow rays from the hit points ``p`` (lifted 1e-3 along
    the normal; dead lanes parked): origins, unit directions to the light,
    and the distances to it."""
    to_l = light_pos[None] - p
    dist_l = torch.linalg.vector_norm(to_l, dim=-1)
    wl = to_l / torch.clamp_min(dist_l[:, None], 1e-20)
    sh_o = torch.where(live[:, None], p + nrm * 1e-3, _PARK)
    return sh_o, wl, dist_l


def make_pathtracer(scene, tris, bounces: int = 2, packet: int = 2048,
                    light_pos=(12.0, 22.0, 8.0),
                    light_col=(1.4, 1.344, 1.26),
                    sky=(0.45, 0.6, 0.85),
                    albedo=(0.75, 0.72, 0.68),
                    light_power: float = 500.0, device=None):
    """A renderer ``trace(origins, directions, generator) -> color [n, 3]``.

    ``scene`` is a TightScene; ``tris`` the (a, b, c) vertex arrays, for
    the exact winner recompute and the normals. ``generator`` is a
    ``torch.Generator`` on the device that draws the bounce directions.
    ``device``: where to run (None: the card).
    """
    dev = resolve_device(device)
    v9 = torch.cat([torch.as_tensor(x, dtype=torch.float32, device=dev)
                    for x in tris], dim=1)
    tris_d = (v9[:, 0:3], v9[:, 3:6], v9[:, 6:9])
    lp, lc, sk, al = (torch.tensor(x, dtype=torch.float32, device=dev)
                      for x in (light_pos, light_col, sky, albedo))

    def trace(origins, directions, generator: torch.Generator) -> torch.Tensor:
        o = torch.as_tensor(origins, dtype=torch.float32, device=dev)
        d = torch.as_tensor(directions, dtype=torch.float32, device=dev)
        npx = o.shape[0]
        color = torch.zeros((npx, 3), dtype=torch.float32, device=dev)
        throughput = torch.ones((npx, 3), dtype=torch.float32, device=dev)
        alive = torch.ones(npx, dtype=torch.bool, device=dev)
        for bounce in range(bounces + 1):
            # bounce waves scatter into the sky: the sweep gate skips the
            # packets that cannot hit (the primary wave is hit-dense)
            hit = trace_closest_hit_tight(scene, Ray.create(o, d, device=dev),
                                          tris=tris_d, packet=packet,
                                          sweep=bounce > 0, device=dev)
            found, p, nrm = hit_frames(hit, o, d, v9)
            color = color + torch.where((~found & alive)[:, None],
                                        throughput * sk, 0.0)
            hitm = found & alive

            sh_o, wl, dist_l = shadow_rays(p, nrm, hitm, lp)
            occluded = trace_any_hit_tight(
                scene, Ray.create(sh_o, wl, device=dev), t_max=dist_l * 0.999,
                packet=packet, sweep=True, device=dev)
            ndl = torch.clamp_min(torch.sum(nrm * wl, -1), 0.0)
            lit = hitm & ~occluded
            falloff = light_power / torch.clamp_min(dist_l, 1.0) ** 2
            color = color + torch.where(
                lit[:, None],
                throughput * al[None] * lc[None] * (ndl * falloff)[:, None],
                0.0)

            alive = hitm
            if bounce == bounces:
                break
            throughput = torch.where(alive[:, None], throughput * al[None],
                                     throughput)
            u = _normalize(bounce_noise(npx, generator, dev))
            u = torch.where(torch.sum(u * nrm, -1, keepdim=True) < 0, -u, u)
            o = torch.where(alive[:, None], p + nrm * 1e-3, _PARK)
            d = torch.where(alive[:, None], _normalize(nrm + u), 1.0)
        return color

    return trace
