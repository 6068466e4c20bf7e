"""Triangle utilities: exact point-triangle distance (batched).

Counterpart of ``bvh_tpu/tri.py``: the standard closest-point-on-triangle
region classification (Ericson, Real-Time Collision Detection §5.1.5), the
analog of the reference testbase's ``Triangle::distance_squared``, written
with selects so that it broadcasts over any leading shape. It is the
brute-force oracle of the nearest-triangle queries.
"""

from __future__ import annotations

import torch


def _safe(x: torch.Tensor) -> torch.Tensor:
    """``x`` with exact zeros replaced by 1 (a divisor for a region that is
    not selected)."""
    return torch.where(x == 0.0, torch.ones_like(x), x)


def closest_point_on_triangle(p: torch.Tensor, a: torch.Tensor,
                              b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Closest point to ``p`` on triangle ``abc``; all inputs [..., 3]."""
    ab = b - a
    ac = c - a
    ap = p - a

    d1 = torch.sum(ab * ap, dim=-1)
    d2 = torch.sum(ac * ap, dim=-1)
    in_a = (d1 <= 0.0) & (d2 <= 0.0)

    bp = p - b
    d3 = torch.sum(ab * bp, dim=-1)
    d4 = torch.sum(ac * bp, dim=-1)
    in_b = (d3 >= 0.0) & (d4 <= d3)

    cp = p - c
    d5 = torch.sum(ab * cp, dim=-1)
    d6 = torch.sum(ac * cp, dim=-1)
    in_c = (d6 >= 0.0) & (d5 <= d6)

    vc = d1 * d4 - d3 * d2
    in_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    v_ab = d1 / _safe(d1 - d3)

    vb = d5 * d2 - d1 * d6
    in_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    w_ac = d2 / _safe(d2 - d6)

    va = d3 * d6 - d5 * d4
    in_bc = (va <= 0.0) & (d4 - d3 >= 0.0) & (d5 - d6 >= 0.0)
    w_bc = (d4 - d3) / _safe((d4 - d3) + (d5 - d6))

    denom = _safe(va + vb + vc)
    v_in = vb / denom
    w_in = vc / denom

    # priority order matches the sequential early returns
    out = a + ab * v_in[..., None] + ac * w_in[..., None]
    out = torch.where(in_bc[..., None], b + (c - b) * w_bc[..., None], out)
    out = torch.where(in_ac[..., None], a + ac * w_ac[..., None], out)
    out = torch.where(in_ab[..., None], a + ab * v_ab[..., None], out)
    out = torch.where(in_c[..., None], c, out)
    out = torch.where(in_b[..., None], b, out)
    out = torch.where(in_a[..., None], a, out)
    return out


def point_triangle_distance_squared(p: torch.Tensor, a: torch.Tensor,
                                    b: torch.Tensor,
                                    c: torch.Tensor) -> torch.Tensor:
    """Squared distance from ``p`` to triangle ``abc``; inputs [..., 3]."""
    d = p - closest_point_on_triangle(p, a, b, c)
    return torch.sum(d * d, dim=-1)
