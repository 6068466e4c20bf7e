"""Wavefront path tracing over a ``TightScene``: closest-hit waves, next-event
shadow waves to a point light, and Lambertian bounces.

Counterpart of ``bvh_tpu/render.py::make_pathtracer``. Each frame runs
``bounces + 1`` closest-hit waves and ``bounces + 1`` shadow waves through
the port's trace kernels; everything between them is elementwise PyTorch on
the same device. Dead lanes are parked at origin 2e30, where they miss at
the root, rather than compacted, and bounce waves are not re-sorted: they
inherit the primary tiles' image-space coherence. The primary wave runs
without the sweep gate, every bounce and shadow wave with it, as in the
reference. The bounce noise is ``[npx, 3]`` standard normals a bounce:
passed in by the caller, or drawn from the caller's ``torch.Generator``,
one draw per bounce (``bounce_noise``); it is not the JAX key's stream.

A frame opens the span ``render`` (``obs``) and inside it, one a wave:
``primary`` (the first closest-hit wave and its hit frames), ``bounce``
(each later one), ``shadow`` (the shadow rays and the any-hit wave) and
``shade`` (colour, throughput and the next rays).

A frame of fixed size makes some 550 launches, which take the host longer
than the card takes to run them; ``graph=True`` captures such a frame once
as a CUDA graph and replays it.
"""

from __future__ import annotations

import torch

from . import obs
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
                    light_power: float = 500.0, graph: bool = False,
                    device=None):
    """A renderer ``trace(origins, directions, generator=None, noise=None,
    waves=False) -> color [n, 3]``.

    ``scene`` is a TightScene; ``tris`` the (a, b, c) vertex arrays, for
    the exact winner recompute and the normals. The bounce directions come
    from exactly one of ``generator``, a ``torch.Generator`` on the device
    that draws them, and ``noise``, ``[n, bounces, 3]`` float32 standard
    normals (bounce ``k`` takes ``noise[:, k]``); the same normals give the
    same colours bit for bit. ``waves=True`` returns ``(color, *answers)``:
    per wave, the closest-hit wave's rays ``o``, ``d`` and answers ``t``,
    ``shape_id``, then the shadow wave's origins, unit directions, distances
    to the light and ``occluded``, all [n] or [n, 3] per pixel as the frame
    traced them (dead lanes parked). ``device``: where to run (None: the
    card).

    ``graph=True``: on the card, a frame given ``noise`` while the spans are
    off is captured as a CUDA graph the first time its size (and ``waves``)
    comes, after one frame run as usual on a side stream, and replayed from
    then on: the call copies the rays and the noise into the graph's inputs
    and launches the graph. The answers are the frame's bit for bit, but
    they are the graph's own tensors, which the next call of that size
    overwrites: copy what you keep. A generator, spans on (a replay opens
    none), a recording profiler (it can place no replayed kernel in a
    launch of its own) or the CPU run the frame as usual: the same kernels
    on the same data.
    """
    dev = resolve_device(device)
    v9 = torch.cat([torch.as_tensor(x, dtype=torch.float32, device=dev)
                    for x in tris], dim=1)
    tris_d = (v9[:, 0:3], v9[:, 3:6], v9[:, 6:9])
    lp, lc, sk, al = (torch.tensor(x, dtype=torch.float32, device=dev)
                      for x in (light_pos, light_col, sky, albedo))

    def closest(o, d, sweep: bool):
        """One closest-hit wave and its hit frames."""
        hit = trace_closest_hit_tight(scene, Ray.create(o, d, device=dev),
                                      tris=tris_d, packet=packet, sweep=sweep,
                                      device=dev)
        return (hit, *hit_frames(hit, o, d, v9))

    graphs = {}  # (npx, waves) -> (graph, its inputs, its answers)

    def trace(origins, directions, generator: torch.Generator | None = None,
              noise=None, waves: bool = False):
        if (generator is None) == (noise is None):
            raise ValueError("give exactly one of generator and noise")
        if (graph and noise is not None and dev.type == "cuda"
                and not obs.enabled()
                and not torch.autograd._profiler_enabled()):
            return replay(origins, directions, noise, waves)
        return frame(origins, directions, generator, noise, waves)

    def replay(origins, directions, noise, waves: bool):
        ins = [torch.as_tensor(x, dtype=torch.float32, device=dev)
               for x in (origins, directions, noise)]
        npx = ins[0].shape[0]
        if ins[2].shape != (npx, bounces, 3):
            raise ValueError(f"noise {tuple(ins[2].shape)} is not "
                             f"{(npx, bounces, 3)}")
        key = (npx, waves)
        if key not in graphs:
            mine = [x.clone() for x in ins]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                frame(*mine[:2], None, mine[2], waves)  # loads what it reads
            torch.cuda.current_stream(dev).wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = frame(*mine[:2], None, mine[2], waves)
            graphs[key] = g, mine, out
        g, mine, out = graphs[key]
        for x, y in zip(mine, ins):
            x.copy_(y)
        g.replay()
        return out

    def frame(origins, directions, generator, noise, waves: bool):
        answers = []
        with obs.span("render"):
            with obs.span("primary"):
                o = torch.as_tensor(origins, dtype=torch.float32, device=dev)
                d = torch.as_tensor(directions, dtype=torch.float32, device=dev)
                npx = o.shape[0]
                if noise is not None:
                    noise = torch.as_tensor(noise, dtype=torch.float32,
                                            device=dev)
                    if noise.shape != (npx, bounces, 3):
                        raise ValueError(f"noise {tuple(noise.shape)} is not "
                                         f"{(npx, bounces, 3)}")
                color = torch.zeros((npx, 3), dtype=torch.float32, device=dev)
                throughput = torch.ones((npx, 3), dtype=torch.float32,
                                        device=dev)
                alive = torch.ones(npx, dtype=torch.bool, device=dev)
                # the primary wave is hit-dense: no sweep gate
                hit, found, p, nrm = closest(o, d, False)
            for bounce in range(bounces + 1):
                if bounce:
                    with obs.span("bounce"):
                        # bounce waves scatter into the sky: the sweep gate
                        # skips the packets that cannot hit
                        hit, found, p, nrm = closest(o, d, True)

                with obs.span("shadow"):
                    hitm = found & alive
                    sh_o, wl, dist_l = shadow_rays(p, nrm, hitm, lp)
                    occluded = trace_any_hit_tight(
                        scene, Ray.create(sh_o, wl, device=dev),
                        t_max=dist_l * 0.999, packet=packet, sweep=True,
                        device=dev)
                if waves:
                    answers += [o, d, hit.t, hit.shape_id, sh_o, wl, dist_l,
                                occluded]

                with obs.span("shade"):
                    color = color + torch.where((~found & alive)[:, None],
                                                throughput * sk, 0.0)
                    ndl = torch.clamp_min(torch.sum(nrm * wl, -1), 0.0)
                    lit = hitm & ~occluded
                    falloff = light_power / torch.clamp_min(dist_l, 1.0) ** 2
                    color = color + torch.where(
                        lit[:, None],
                        throughput * al[None] * lc[None]
                        * (ndl * falloff)[:, None], 0.0)

                    alive = hitm
                    if bounce == bounces:
                        break
                    throughput = torch.where(alive[:, None],
                                             throughput * al[None], throughput)
                    u = (bounce_noise(npx, generator, dev) if noise is None
                         else noise[:, bounce].contiguous())
                    u = _normalize(u)
                    u = torch.where(torch.sum(u * nrm, -1, keepdim=True) < 0,
                                    -u, u)
                    o = torch.where(alive[:, None], p + nrm * 1e-3, _PARK)
                    d = torch.where(alive[:, None], _normalize(nrm + u), 1.0)
        return (color, *answers) if waves else color

    return trace
