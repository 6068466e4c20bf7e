"""Whether the timed path's answers are correct: a sample of the answers
that the window produced, drawn from the seed, against the plain
reference, which works from the triangles and the rays or points alone.
What is compared is the entry's (``entries/<kind>.py``: ``numbers``); each
number has its limit in the cell's file (``cells/<cell>.json``).
"""

from __future__ import annotations

import torch


def sample_rows(labels, n: int, per_slot: int, g: torch.Generator):
    """``per_slot`` row indices of a batch of ``n``, drawn with ``g``: split
    evenly over the parts where ``labels`` marks several."""
    if labels is None:
        return torch.randperm(n, generator=g)[:per_slot]
    lab = labels.cpu()
    parts = int(lab.max()) + 1
    out = []
    for k in range(parts):
        idx = torch.nonzero(lab == k).reshape(-1)
        out.append(idx[torch.randperm(len(idx), generator=g)[:per_slot // parts]])
    return torch.cat(out)


def worst(x) -> float:
    """The largest of ``x``, 0 when it is empty."""
    return float(x.max()) if x.numel() else 0.0


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every number lies within its limit (a NaN never does), and
    each number beside its limit."""
    ok = all(found[k] <= limits[k] for k in found)
    return ok, {k: {"value": found[k], "limit": limits[k]} for k in found}
