"""The path-tracing entry: ``bvh_tpu_torch.render.make_pathtracer``'s
renderer over the scene ``SCENE``, a batch of camera rays and their bounce
noise (origins, directions, noise [n, bounces, 3]) in, and the frame's
answers out, each pixel's in one row of two tensors (``pack``): values
[n, 4 W + 3, 3] float (the colour; per wave the closest-hit wave's ``o``
and ``d`` and the shadow wave's origin and unit direction; then each
wave's closest-hit t, and each wave's distance to the light) and ids
[n, 2 W] int32 (per wave the closest hit's triangle and the shadow ray's
occlusion, 0 or 1), for W = bounces + 1 waves. Both are views of
buffers laid out answer by answer, so that the pack copies each answer
whole. The renderer runs as a replayed CUDA graph where the mix's
``args`` ask for ``graph``; the pack is the copy that keeps each frame's
answers.

How the answers are judged: each wave against float64 brute force on that
wave's own rays as the answers carry them, and the glue against float64
glue on the wave before's own answers, so that one wrong answer does not
cascade into the waves after it. Over the sampled pixels:

* ``flips``, ``t_err``, ``gap``: over the closest-hit waves' live rays, as
  ``entries/tracer.py`` defines them;
* ``shadow_flips``: the share of live shadow rays whose occlusion differs
  from brute-force any hit below their own t_max (0.999 of their distance
  to the light); an occlusion other than 0 or 1 differs;
* ``ray_err``: the largest error of the rays each wave starts from: the
  primary wave's against the pixel's camera ray (relatively; they are
  the same tensors), each shadow wave's and
  each next wave's against the float64 glue on the wave's own answers and
  the pixel's noise. Points relative to the reach of the ray they lie on
  (``|o| + t``), unit directions absolutely, distances relatively;
  infinite where a lane is parked that should live, or the reverse;
* ``c_err``: the largest colour error against float64 shading of the
  answers' own hits and occlusion, relative to the pixel's colour with
  every live hit lit at full incidence (a cosine near 0 rounds to either
  side of the clamp).

The light and the sky are the scene's (``scenes/spd_tetra.py``); the
albedo and the light's colour are the renderer's defaults. The harness
hands the entry's ``reference`` and ``numbers`` no configuration, so the
scene is named here, and ``make`` refuses a configuration whose
triangles are not that scene's.
"""

import math
from pathlib import Path

import numpy as np
import torch

from portbench import plugin
from portbench.check import worst
from portbench.reference import path

INPUTS = 3  # a batch is (origins, directions, noise)
WORK = None  # the work model walks no bounce or shadow wave: no bound
NUMBERS = ("flips", "t_err", "gap", "shadow_flips", "ray_err", "c_err")

ROOT = Path(__file__).resolve().parents[2]
TRACER = plugin(ROOT, "entries", "tracer")  # one wave's closest hits
SCENE = "spd_tetra"
_MAKER = plugin(ROOT, "scenes", SCENE)
SHADING = {"light_pos": _MAKER.LIGHT, "light_col": (1.4, 1.344, 1.26),
           "sky": _MAKER.BACKGROUND, "albedo": (0.75, 0.72, 0.68),
           "light_power": _MAKER.LIGHT_POWER}


def _check_scene(tris_np) -> None:
    """Raises unless ``tris_np`` is ``SCENE``'s pyramid at some size."""
    n = tris_np[0].shape[0]
    sf = round(math.log(max(n, 1), 4)) - 1
    if sf < 0 or 4 ** (sf + 1) != n or not all(
            np.array_equal(x, y) for x, y in zip(tris_np, _MAKER.make(sf))):
        raise ValueError(f"the entry pathtracer lights the scene {SCENE!r}; "
                         f"these {n} triangles are not it")


def pack(out: tuple) -> tuple:
    """A frame in ``waves=True`` form as (values, ids), a row a pixel."""
    rays, ts, dists, ids = [out[0]], [], [], []
    for k in range(1, len(out), path.WAVE):
        o, d, t, sid, sh_o, wl, dist, occ = out[k:k + path.WAVE]
        rays += [o, d, sh_o, wl]
        ts.append(t)
        dists.append(dist)
        ids += [sid.to(torch.int32), occ.to(torch.int32)]
    values = torch.stack(rays + [torch.stack(ts, dim=1),
                                 torch.stack(dists, dim=1)])
    return values.permute(1, 0, 2), torch.stack(ids).t()


def unpack(out: tuple) -> tuple:
    """(values, ids) back in ``waves=True`` form, as views; occlusion as
    the int32 it was packed as."""
    values, ids = out
    n_waves = ids.shape[1] // 2
    waves = []
    for k in range(n_waves):
        o, d, sh_o, wl = (values[:, 1 + 4 * k + j] for j in range(4))
        waves += [o, d, values[:, -2, k], ids[:, 2 * k], sh_o, wl,
                  values[:, -1, k], ids[:, 2 * k + 1]]
    return (values[:, 0], *waves)


def make(scene, tris_np, device, spec: dict):
    """The timed call. ``spec``: the mix's ``entry``; ``args`` (``bounces``,
    ``packet``, ``graph``) go to ``make_pathtracer`` beside ``SHADING``."""
    from bvh_tpu_torch.render import make_pathtracer
    _check_scene(tris_np)
    trace = make_pathtracer(scene, tris_np, device=device, **SHADING,
                            **spec.get("args", {}))

    def call(batch):
        o, d, noise = batch
        return pack(trace(o, d, noise=noise, waves=True))
    return call


def reference(rows: tuple, tris, dtype=torch.float64):
    """The reference's frame over ``rows``, every wave by brute force in
    ``dtype``, packed as the call packs it."""
    return pack(path.render(*rows, tris, SHADING, dtype=dtype))


def _parked(o):
    return (o == path.PARK).all(dim=-1)


def _point_err(x, ref, reach):
    return torch.linalg.vector_norm(x.double() - ref, dim=-1) / reach


def _dir_err(x, ref):
    return torch.linalg.vector_norm(x.double() - ref, dim=-1)


def numbers(rows: tuple, out: tuple, tris) -> dict:
    """The compared numbers of the packed frame ``out`` over ``rows``."""
    out = unpack(out)
    o_cam, d_cam, noise = rows
    bounces = noise.shape[1]
    f64 = torch.float64
    light = torch.as_tensor(SHADING["light_pos"], dtype=f64,
                            device=o_cam.device)
    color64 = torch.zeros((o_cam.shape[0], 3), dtype=f64, device=o_cam.device)
    full64, thr = color64.clone(), color64 + 1
    alive = torch.ones(o_cam.shape[0], dtype=torch.bool, device=o_cam.device)
    flips, n_live, t_err, gap = 0.0, 0, 0.0, 0.0
    sh_flips, n_sh = 0, 0
    # the primary wave starts from the camera rays as given
    o, d = out[1], out[2]
    ray_errs = [_point_err(o, o_cam.double(),
                           torch.linalg.vector_norm(o_cam.double(), dim=-1)),
                _point_err(d, d_cam.double(),
                           torch.linalg.vector_norm(d_cam.double(), dim=-1))]
    for k in range(bounces + 1):
        o, d, t, ids, sh_o, wl, dist, occ = out[1 + path.WAVE * k:
                                                1 + path.WAVE * (k + 1)]
        o64, d64, t64 = o.double(), d.double(), t.double()
        n = int(alive.sum())
        if n:
            w = TRACER.numbers((o64[alive], d64[alive]),
                               (t64[alive], ids[alive]), tris)
            flips, n_live = flips + w["flips"] * n, n_live + n
            t_err, gap = max(t_err, w["t_err"]), max(gap, w["gap"])

        # the glue in float64 on this wave's own answers
        found, p, nrm = path.hit_frames(o64, d64, t64, ids, tris)
        hitm = found & alive
        reach = torch.linalg.vector_norm(o64, dim=-1) + torch.where(
            found, t64, 0.0)
        sh_o64, wl64, dist64 = path.shadow_rays(p, nrm, hitm, light)
        ray_errs += [
            torch.where(_parked(sh_o) == ~hitm, 0.0, math.inf),
            _point_err(sh_o[hitm], sh_o64[hitm], reach[hitm]),
            _dir_err(wl[hitm], wl64[hitm]),
            (dist[hitm].double() - dist64[hitm]).abs() / dist64[hitm]]
        # this wave's shadow rays, as the answers carry them, by brute force
        sh_t = dist[hitm].double() * path.SHADOW_REACH
        occ_ref = path.occluded(sh_o[hitm].double(), wl[hitm].double(), sh_t,
                                tris)
        sh_flips += int((occ_ref.to(torch.int32) != occ[hitm]).sum())
        n_sh += int(hitm.sum())

        # the colour in float64 from this wave's own hits and occlusion
        occ64 = occ != 0
        color64, thr_new = path.shade(color64, thr, found, alive, nrm, wl64,
                                      dist64, occ64, SHADING)
        full64, _ = path.shade(full64, thr, found, alive, nrm, wl64, dist64,
                               occ64, SHADING, full=True)
        thr, alive = thr_new, hitm
        if k < bounces:
            o_n, d_n = out[1 + path.WAVE * (k + 1):3 + path.WAVE * (k + 1)]
            o_n64, d_n64 = path.next_rays(p, nrm, hitm, noise[:, k])
            ray_errs += [
                torch.where(_parked(o_n) == ~hitm, 0.0, math.inf),
                _point_err(o_n[hitm], o_n64[hitm], reach[hitm]),
                _dir_err(d_n[hitm], d_n64[hitm])]
    scale = full64.abs().amax(dim=-1)
    c_err = (out[0].double() - color64).abs().amax(dim=-1) / scale
    return {"flips": flips / max(n_live, 1),
            "t_err": t_err, "gap": gap,
            "shadow_flips": sh_flips / max(n_sh, 1),
            "ray_err": max(worst(e) for e in ray_errs),
            "c_err": worst(c_err)}
