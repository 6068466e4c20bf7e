"""The one traffic generator: a mix's data file in, a pool of distinct
batches on the device out, all drawn from the run's seed by a
``torch.Generator`` on that device, in a few large calls.

A mix's ``parts`` share each batch; each part's ``kind`` names the file
``kinds/<kind>.py`` whose ``make(n, g, part, ctx)`` draws its ``n`` rows
with the generator ``g``, from the part's own parameters and ``ctx``
(``tris``: the scene's triangles on the device; ``device``), as a tuple
of per-row arrays: (origins, directions), or more, such as a per-ray
t_max beside them. The parts' rows are shuffled together, and a part's
label is kept for the check's sample. A batch keeps the first ``inputs``
arrays: (o, d) for rays, (o,) for points, (o, d, t_max) for bounded rays.
"""

from __future__ import annotations

from pathlib import Path

import torch

from . import plugin

ROOT = Path(__file__).resolve().parent.parent


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def part_sizes(batch: int, parts: list) -> list:
    """Units of each part in a batch: every part but the first takes its
    share, rounded; the first takes the rest."""
    rest = [int(round(batch * float(p["share"]))) for p in parts[1:]]
    return [batch - sum(rest)] + rest


def make_pool(mix: dict, tris, seed: int, device, inputs: int,
              root: Path = ROOT):
    """``mix["pool"]`` batches of ``mix["batch"]`` units, each a tuple of
    ``inputs`` per-row tensors ([n, 3] or [n]), and the parts' labels of
    each batch (None for a mix of one part)."""
    kinds = [plugin(root, "kinds", p["kind"]) for p in mix["parts"]]
    ctx = {"tris": tris, "device": device}
    g = _gen(seed, device)
    sizes = part_sizes(int(mix["batch"]), mix["parts"])
    pool, labels = [], []
    for _ in range(int(mix["pool"])):
        cols = [kind.make(n, g, p, ctx)
                for kind, p, n in zip(kinds, mix["parts"], sizes)]
        batch = [torch.cat(c) for c in zip(*cols)][:inputs]
        lab = None
        if len(sizes) > 1:
            lab = torch.repeat_interleave(
                torch.arange(len(sizes), device=device),
                torch.tensor(sizes, device=device)).to(torch.int8)
            perm = torch.randperm(lab.shape[0], generator=g, device=device)
            batch, lab = [x[perm] for x in batch], lab[perm]
        pool.append(tuple(x.contiguous() for x in batch))
        labels.append(lab)
    return pool, labels
