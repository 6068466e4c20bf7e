"""The repository's aimed rays (``bench.py:161-179``): the scene's cubes
(``group`` consecutive triangles each) taken in turn, a ray starting
``dist`` from a cube's centre in a uniformly drawn direction and pointing
at the centre plus ``aim`` on every axis."""

import torch


def make(n, g, part, ctx):
    a = ctx["tris"][0]
    centers = a.reshape(-1, int(part["group"]), 3).mean(dim=1)
    m = centers.shape[0]
    # cubes in turn, as numpy.resize then a stable sort: the first n % m
    # cubes take one ray more
    counts = torch.full((m,), n // m, device=a.device)
    counts[:n % m] += 1
    c = centers.repeat_interleave(counts, dim=0)
    off = torch.randn((n, 3), generator=g, device=a.device)
    off = off / torch.linalg.vector_norm(off, dim=1, keepdim=True)
    o = c + off * float(part["dist"])
    return o, c + float(part["aim"]) - o
