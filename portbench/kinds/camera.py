"""Jittered pinhole camera rays of a scene's view, and each pixel's bounce
noise: a square image of ``n`` pixels (``n`` a square, its side a multiple
of ``tile``), one sample a pixel, the pixels ordered tile by tile
(``tile`` x ``tile`` tiles in row-major order, row-major inside a tile):
the image-space coherence a renderer that does not sort relies on.

The view is the scene maker's ``VIEW`` (``scenes/<part["scene"]>.py``):
eye, look-at point, up vector and vertical field of view in degrees. A
pixel's sample lies uniformly in the pixel. Rows: origins [n, 3],
directions [n, 3] (not normalized), and the bounce noise [n, bounces, 3],
standard normals; everything drawn from the run's generator.
"""

import math
from pathlib import Path

import torch

from portbench import plugin

ROOT = Path(__file__).resolve().parents[2]


def pixel_order(side: int, tile: int, device):
    """Each row's pixel (x, y), the tiles and their pixels in row-major
    order."""
    if side % tile:
        raise ValueError(f"side {side} is no multiple of the tile {tile}")
    k = torch.arange(side * side, device=device)
    per_row = side // tile
    t, i = k // (tile * tile), k % (tile * tile)
    return (t % per_row) * tile + i % tile, (t // per_row) * tile + i // tile


def make(n, g, part, ctx):
    dev = ctx["device"]
    side, tile = math.isqrt(n), int(part["tile"])
    if side * side != n:
        raise ValueError(f"{n} pixels make no square image")
    view = plugin(ROOT, "scenes", part["scene"]).VIEW
    eye, at, up = (torch.tensor(view[k], dtype=torch.float64, device=dev)
                   for k in ("from", "at", "up"))
    fwd = (at - eye) / torch.linalg.vector_norm(at - eye)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.vector_norm(right)
    up = torch.linalg.cross(right, fwd)
    tan_half = math.tan(math.radians(float(view["angle"])) / 2)
    x, y = pixel_order(side, tile, dev)
    jitter = torch.rand((n, 2), generator=g, device=dev, dtype=torch.float32)
    sx = ((x + jitter[:, 0]) / side * 2 - 1) * tan_half
    sy = (1 - (y + jitter[:, 1]) / side * 2) * tan_half
    d = fwd.float() + sx[:, None] * right.float() + sy[:, None] * up.float()
    o = eye.float().expand(n, 3).contiguous()
    noise = torch.randn((n, int(part["bounces"]), 3), generator=g, device=dev,
                        dtype=torch.float32)
    return o, d, noise
