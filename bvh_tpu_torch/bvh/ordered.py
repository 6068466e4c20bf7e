"""Distance-ordered traversal.

Counterpart of ``bvh_tpu/bvh/ordered.py``. The reference crate orders a
ray's candidate shapes with a heap on slab entry or exit distances; here
the batch collects every leaf it hits, with the distance, in one lock-step
walk (``traverse.py``), and each ray's fixed buffer is sorted: the exact
order of the heap, with no per-ray structure.
"""

from __future__ import annotations

import torch

from ..ray import Ray
from .flat import FlatBvh
from .traverse import (_flat_rays, _gather_node, _lockstep, _set_slot,
                       _slab_entry, _tensors)


def ordered_traverse(flat: FlatBvh, rays: Ray, max_hits: int = 32,
                     ascending: bool = True):
    """The shapes whose boxes the rays hit, ordered by distance per ray:
    ascending by slab entry distance (closest first), or descending by slab
    exit distance (farthest first).

    Returns ``(shape_ids [..., max_hits] int32, distances [..., max_hits],
    count [...] int32)``; unused slots hold -1 and +inf (ascending) or -inf
    (descending). ``count > max_hits`` says the buffer overflowed (the
    later hits then overwrite the last slot before the sort)."""
    rr, batch = _flat_rays(rays)
    r = rr.origin.shape[0]
    dt, dev = rr.origin.dtype, rr.origin.device
    pad = float("inf") if ascending else -float("inf")
    ids = torch.full((r, max_hits), -1, dtype=torch.int32, device=dev)
    dist = torch.full((r, max_hits), pad, dtype=dt, device=dev)
    count = torch.zeros(r, dtype=torch.int32, device=dev)
    n = flat.num_nodes
    if n:
        f = _tensors(flat, dev)
        cursor = torch.zeros(r, dtype=torch.int64, device=dev)

        def step(idx):
            cur = cursor[idx]
            active = cur < n
            nmin, nmax, entry, exit_, shape = _gather_node(f, cur)
            hit, tmin, tmax = _slab_entry(nmin, nmax, rr.origin[idx],
                                          rr.inv_direction[idx])
            is_leaf = entry < 0
            record = active & is_leaf & hit
            ci = count[idx]
            _set_slot(ids, idx, ci, shape.to(torch.int32), record)
            _set_slot(dist, idx, ci, tmin if ascending else tmax, record)
            count[idx] = ci + record.to(torch.int32)
            cursor[idx] = torch.where(
                active, torch.where(is_leaf | ~hit, exit_, entry), cur)

        _lockstep(cursor, n, step)
        order = torch.argsort(dist if ascending else -dist, dim=-1,
                              stable=True)
        ids = ids.gather(-1, order)
        dist = dist.gather(-1, order)
    shape = tuple(batch) + (max_hits,)
    return ids.reshape(shape), dist.reshape(shape), count.reshape(batch)


def nearest_traverse(flat: FlatBvh, rays: Ray, max_hits: int = 32):
    """Closest-first candidates (the reference's ``nearest_traverse``)."""
    return ordered_traverse(flat, rays, max_hits, ascending=True)


def farthest_traverse(flat: FlatBvh, rays: Ray, max_hits: int = 32):
    """Farthest-first candidates (the reference's ``farthest_traverse``)."""
    return ordered_traverse(flat, rays, max_hits, ascending=False)
