"""The nearest-triangle entry: ``bvh_tpu_torch.ops.nearest.nearest_tight``
over the configuration's scene, a batch of points in, (distance, triangle
id) out in the batch's order; and how its answers are judged against the
plain reference over the sampled points:

* ``d_err``: the largest relative error of the distance;
* ``gap``: the largest relative excess of the program's triangle's
  distance over the least; infinite for an id that names none.
"""

import math

import torch

from portbench.check import worst
from portbench.reference import nearest

INPUTS = 1  # a batch is (points,)
WORK = "points"  # what the work model walks; None: no bound, no roofline
NUMBERS = ("d_err", "gap")


def make(scene, tris_np, device, spec: dict):
    """The timed call. ``spec``: the mix's ``entry``; ``args`` go to
    ``nearest_tight``."""
    from bvh_tpu_torch.ops.nearest import nearest_tight
    args = spec.get("args", {})

    def call(batch):
        sid, dist = nearest_tight(scene, batch[0], device=device, **args)
        return dist, sid
    return call


def reference(rows: tuple, tris, dtype=torch.float64):
    """The reference's answers (distance, id) to ``rows`` in ``dtype``."""
    return nearest.nearest(rows[0], tris, dtype=dtype)


def numbers(rows: tuple, out: tuple, tris) -> dict:
    """The compared numbers of the answers ``out`` to ``rows``."""
    (p,) = rows
    value, ident = out[0].double(), out[1].long()
    n_tris = tris[0].shape[0]
    valid = (ident >= 0) & (ident < n_tris)
    d_ref, _ = nearest.nearest(p, tris)
    den = d_ref.clamp_min(1e-30)
    d_err = (value - d_ref).abs() / den
    d_of = nearest.distance_to(p, tris, ident.clamp(0, n_tris - 1))
    gap = torch.where(valid, (d_of - d_ref) / den, math.inf)
    return {"d_err": worst(torch.nan_to_num(d_err, nan=math.inf)),
            "gap": worst(gap)}
