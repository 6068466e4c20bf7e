"""Closest hit by brute force: every ray against every triangle, in plain
PyTorch, in blocks of rays.

The semantics are the program's stated ones (the crate's ``Ray::
intersects_triangle``): Moller-Trumbore with backface culling, a miss where
the determinant is below ``EPS``, where u, v or u + v leave [0, 1], or where
t <= ``EPS``; ``EPS`` is float32's machine epsilon, the configuration's
precision, whatever ``dtype`` the reference computes in. Each ray works in
its own frame: the triangles are taken relative to its origin in float64,
which is exact for float32 inputs, and only then rounded to ``dtype``.
Directions are normalized in ``dtype``. Cross and dot products are written
out term by term.
"""

from __future__ import annotations

import torch

EPS = float(torch.finfo(torch.float32).eps)
BLOCK = 1 << 22  # rays x triangles per block


def _cross(x, y):
    x0, x1, x2 = x.unbind(-1)
    y0, y1, y2 = y.unbind(-1)
    return torch.stack([x1 * y2 - x2 * y1, x2 * y0 - x0 * y2,
                        x0 * y1 - x1 * y0], dim=-1)


def _dot(x, y):
    p = x * y
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _terms(o, dn, a, b, c):
    """Moller-Trumbore's determinant, u, v and t, without rejections."""
    e1, e2 = b - a, c - a
    pvec = _cross(dn, e2)
    det = _dot(e1, pvec)
    det_ = torch.where(det == 0, torch.ones_like(det), det)
    tvec = o - a
    qvec = _cross(tvec, e1)
    return (det, _dot(tvec, pvec) / det_, _dot(dn, qvec) / det_,
            _dot(e2, qvec) / det_)


def _rays(o, d, dtype):
    o, d = o.to(dtype), d.to(dtype)
    return o, d / torch.sqrt(_dot(d, d))[:, None]


def closest_hits(o, d, tris, dtype=torch.float64):
    """The closest front-facing hit of each ray ``o``, ``d`` ([S, 3]) over
    the triangles ``tris`` = (a, b, c) ([N, 3] tensors on the same device):
    ``(t [S] float64, +inf on a miss; id [S] int64, -1 on a miss)``. The
    lowest id wins a tie."""
    o64, dn = o.double(), _rays(o, d, dtype)[1]
    tris64 = tuple(x.double()[None] for x in tris)
    zero = torch.zeros((1, 1, 3), dtype=dtype, device=o.device)
    chunk = max(1, BLOCK // tris64[0].shape[1])
    ts, ids = [], []
    for s in range(0, o.shape[0], chunk):
        oc = o64[s:s + chunk, None]
        a, b, c = ((x - oc).to(dtype) for x in tris64)
        det, u, v, t = _terms(zero, dn[s:s + chunk, None], a, b, c)
        miss = ((det < EPS) | (u < 0) | (u > 1) | (v < 0) | (u + v > 1)
                | (t <= EPS))
        t = torch.where(miss, torch.full_like(t, float("inf")), t)
        tmin, arg = t.min(dim=1)
        ts.append(tmin.double())
        ids.append(torch.where(torch.isfinite(tmin), arg, -1))
    return torch.cat(ts), torch.cat(ids)


def on_triangles(o, d, tris, ids):
    """Each ray against the one triangle ``ids[i]`` in float64, without
    rejections: ``(t, outside, front)``, t where the ray meets the
    triangle's plane, ``outside`` how far the meeting point lies outside the
    triangle in barycentric units (0 inside), ``front`` whether the
    triangle faces the ray (det >= EPS)."""
    o, dn = _rays(o, d, torch.float64)
    a, b, c = (x.double()[ids] for x in tris)
    det, u, v, t = _terms(o, dn, a, b, c)
    zero = torch.zeros_like(u)
    outside = torch.maximum(torch.maximum(-u, -v),
                            torch.maximum(u + v - 1, zero)).clamp_min(0)
    return t, outside, det >= EPS
