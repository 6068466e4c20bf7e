"""Nearest triangle by brute force: every point against every triangle, in
plain PyTorch, in blocks of points.

The closest point on a triangle by Voronoi regions (Ericson, Real-Time
Collision Detection 5.1.5), written with selects in the priority order of
its sequential early returns, as the program states its semantics. Each
point works in its own frame: the triangles are taken relative to it in
float64, which is exact for float32 inputs, and only then rounded to the
``dtype`` the reference computes in.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 21  # points x triangles per block


def _safe(x):
    return torch.where(x == 0, torch.ones_like(x), x)


def closest_point(p, a, b, c):
    """The point of triangle ``abc`` nearest to ``p``; inputs [..., 3]."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
    bp = p - b
    d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
    cp = p - c
    d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    denom = _safe(va + vb + vc)
    out = a + ab * (vb / denom)[..., None] + ac * (vc / denom)[..., None]
    regions = (  # lowest priority first
        ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
         b + (c - b) * ((d4 - d3) / _safe((d4 - d3) + (d5 - d6)))[..., None]),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0),
         a + ac * (d2 / _safe(d2 - d6))[..., None]),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0),
         a + ab * (d1 / _safe(d1 - d3))[..., None]),
        ((d6 >= 0) & (d5 <= d6), c),
        ((d3 >= 0) & (d4 <= d3), b),
        ((d1 <= 0) & (d2 <= 0), a))
    for inside, q in regions:
        out = torch.where(inside[..., None], q, out)
    return out


def distance_squared(p, a, b, c):
    q = p - closest_point(p, a, b, c)
    return (q * q).sum(-1)


def nearest(p, tris, dtype=torch.float64):
    """The nearest triangle to each point ``p`` ([S, 3]) over ``tris`` =
    (a, b, c): ``(distance [S] float64, id [S] int64)``; the lowest id wins
    a tie."""
    p64 = p.double()
    tris64 = tuple(x.double()[None] for x in tris)
    zero = torch.zeros((1, 1, 3), dtype=dtype, device=p.device)
    chunk = max(1, BLOCK // tris64[0].shape[1])
    ds, ids = [], []
    for s in range(0, p.shape[0], chunk):
        pc = p64[s:s + chunk, None]
        a, b, c = ((x - pc).to(dtype) for x in tris64)
        d2, arg = distance_squared(zero, a, b, c).min(dim=1)
        ds.append(torch.sqrt(d2.double()))
        ids.append(arg)
    return torch.cat(ds), torch.cat(ids)


def distance_to(p, tris, ids):
    """Float64 distance from each point to the one triangle ``ids[i]``."""
    a, b, c = (x.double()[ids] for x in tris)
    return torch.sqrt(distance_squared(p.double(), a, b, c))
