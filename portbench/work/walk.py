"""Counting walks over the work model's tree: what an ordered,
closest-first, pruned walk needs for each ray or point, in plain PyTorch,
all rays or points of a sample in lock step.

A ray tests the root's box, then at each interior node it pops, both
children's boxes; it pushes the children it enters nearer than its best
hit, the farther first, and pops a node only while the node's entry lies
nearer than its best hit. At a leaf it tests the leaf's triangle. A point
walks the same way by box distance and point-triangle distance.
"""

from __future__ import annotations

import torch

from ..reference import hits, nearest

INV_CLAMP = 1e30  # an inverse direction's magnitude at most, so 0 * inv is 0


def _stack(n: int, depth: int, dev):
    return (torch.zeros((n, depth + 2), dtype=torch.int64, device=dev),
            torch.zeros((n, depth + 2), dtype=torch.float32, device=dev))


def _push(stack, key, sp, cond, node, val):
    rows = torch.arange(stack.shape[0], device=stack.device)
    col = sp.clamp(max=stack.shape[1] - 1)
    stack[rows, col] = torch.where(cond, node, stack[rows, col])
    key[rows, col] = torch.where(cond, val, key[rows, col])
    return sp + cond.long()


def _walk(tree, n: int, dev, box_key, leaf_key):
    """The lock-step walk. ``box_key(nodes) -> (enter, key)``: whether each
    walker enters the boxes and its entry key; ``leaf_key(prims) -> key``.
    Returns (box tests [n], primitive tests [n], best key [n])."""
    stack, key = _stack(n, tree["depth"], dev)
    rows = torch.arange(n, device=dev)
    root = torch.zeros(n, dtype=torch.int64, device=dev)
    best = torch.full((n,), float("inf"), device=dev)
    box_tests = torch.ones(n, dtype=torch.int64, device=dev)
    prim_tests = torch.zeros(n, dtype=torch.int64, device=dev)
    enter, k = box_key(root)
    sp = _push(stack, key, torch.zeros_like(root), enter, root, k)
    while bool((sp > 0).any()):
        act = sp > 0
        top = (sp - 1).clamp(min=0)
        node, k = stack[rows, top], key[rows, top]
        sp = sp - act.long()
        live = act & (k < best)
        prim = tree["prim"][node]
        leaf = live & (prim >= 0)
        inner = live & (prim < 0)
        prim_tests += leaf.long()
        t = leaf_key(prim.clamp(min=0))
        best = torch.where(leaf & (t < best), t, best)
        box_tests += 2 * inner.long()
        left, right = tree["left"][node], tree["right"][node]
        el, kl = box_key(left.clamp(min=0))
        er, kr = box_key(right.clamp(min=0))
        el, er = inner & el & (kl < best), inner & er & (kr < best)
        near_left = kl <= kr
        far, kfar = torch.where(near_left, right, left), torch.where(
            near_left, kr, kl)
        near, knear = torch.where(near_left, left, right), torch.where(
            near_left, kl, kr)
        efar, enear = torch.where(near_left, er, el), torch.where(
            near_left, el, er)
        sp = _push(stack, key, sp, efar, far, kfar)
        sp = _push(stack, key, sp, enear, near, knear)
    return box_tests, prim_tests, best


def ray_walk(tree, tris, o, d):
    """Slab tests, triangle tests and the closest t of each ray ``o``, ``d``
    ([n, 3] float32) over the tree's triangles ``tris`` (a, b, c)."""
    dn = d / torch.sqrt(hits._dot(d, d))[:, None]
    inv = (1.0 / dn).clamp(-INV_CLAMP, INV_CLAMP)
    lo, hi = tree["lo"], tree["hi"]

    def box_key(nodes):
        t1 = (lo[nodes] - o) * inv
        t2 = (hi[nodes] - o) * inv
        tmin = torch.minimum(t1, t2).amax(dim=1).clamp(min=0)
        tmax = torch.maximum(t1, t2).amin(dim=1)
        return tmax >= tmin, tmin

    def leaf_key(prims):
        a, b, c = (x[prims] for x in tris)
        det, u, v, t = hits._terms(o, dn, a, b, c)
        miss = ((det < hits.EPS) | (u < 0) | (u > 1) | (v < 0) | (u + v > 1)
                | (t <= hits.EPS))
        return torch.where(miss, torch.full_like(t, float("inf")), t)

    return _walk(tree, o.shape[0], o.device, box_key, leaf_key)


def point_walk(tree, tris, p):
    """Box tests, point-triangle tests and the least squared distance of each
    point ``p`` ([n, 3] float32) over the tree's triangles."""
    lo, hi = tree["lo"], tree["hi"]

    def box_key(nodes):
        gap = torch.maximum(torch.maximum(lo[nodes] - p, p - hi[nodes]),
                            torch.zeros_like(p))
        return torch.ones(p.shape[0], dtype=torch.bool, device=p.device), (
            gap * gap).sum(dim=1)

    def leaf_key(prims):
        a, b, c = (x[prims] for x in tris)
        return nearest.distance_squared(p, a, b, c)

    return _walk(tree, p.shape[0], p.device, box_key, leaf_key)
