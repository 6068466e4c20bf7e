"""The upstream crate's ``create_ray`` (``src/testbase.rs:686-692``): the
origin and the direction vector are each a point drawn uniformly inside
+-``bound`` on every axis. As points, the origins."""

import torch


def make(n, g, part, ctx):
    b = float(part["bound"])
    x = torch.rand((n, 6), generator=g, device=ctx["device"])
    x = (x * (2 * b) - b).to(torch.float32)
    return x[:, :3], x[:, 3:]
