"""The closest-hit entry: ``bvh_tpu_torch.ops.trace.make_tracer``'s
callable over the configuration's scene, a batch of rays (origins,
directions) in, (t, triangle id) out in the batch's order; and how its
answers are judged against the plain reference over the sampled rays:

* ``flips``: the share whose hit or miss differs from the reference's;
* ``t_err``: the largest relative error of t where both hit;
* ``gap``: where both hit, how far the program's triangle is from a right
  answer: the larger of the relative distance between where the ray meets
  its plane and the reference's t, and how far outside the triangle that
  point lies in barycentric units; infinite for a triangle facing away or
  an id that names none. Two triangles that share the edge a ray hits
  both read about 0, so ties cost nothing.
"""

import math

import torch

from portbench.check import worst
from portbench.reference import hits

INPUTS = 2  # a batch is (origins, directions)
WORK = "rays"  # what the work model walks; None: no bound, no roofline
NUMBERS = ("flips", "t_err", "gap")


def make(scene, tris_np, device, spec: dict):
    """The timed call. ``spec``: the mix's ``entry``; ``tris`` hands the
    triangles to the tracer for its exact winner recompute, ``args`` go to
    ``make_tracer``."""
    from bvh_tpu_torch.ops.trace import make_tracer
    tracer = make_tracer(scene, tris=tris_np if spec.get("tris") else None,
                         device=device, **spec.get("args", {}))

    def call(batch):
        h = tracer(*batch)
        return h.t, h.shape_id
    return call


def reference(rows: tuple, tris, dtype=torch.float64):
    """The reference's answers (t, id) to ``rows`` in ``dtype``."""
    return hits.closest_hits(*rows, tris, dtype=dtype)


def numbers(rows: tuple, out: tuple, tris) -> dict:
    """The compared numbers of the answers ``out`` to ``rows``."""
    o, d = rows
    value, ident = out[0].double(), out[1].long()
    n_tris = tris[0].shape[0]
    valid = (ident >= 0) & (ident < n_tris)
    t_ref, _ = hits.closest_hits(o, d, tris)
    hit_p, hit_r = torch.isfinite(value), torch.isfinite(t_ref)
    both = hit_p & hit_r
    t_err = (value[both] - t_ref[both]).abs() / t_ref[both]
    t_pl, outside, front = hits.on_triangles(
        o[both], d[both], tris, ident[both].clamp(0, n_tris - 1))
    gap = torch.maximum((t_pl - t_ref[both]).abs() / t_ref[both], outside)
    gap = torch.where(front & valid[both], gap, math.inf)
    return {"flips": float((hit_p != hit_r).double().mean()),
            "t_err": worst(t_err), "gap": worst(gap)}
