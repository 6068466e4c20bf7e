"""Invariant checkers over flat node arrays.

Counterpart of ``bvh_tpu/bvh/validate.py`` (numpy): ``check_consistent``
(parent links, box containment, no detached subtree, the DFS layout) and
``check_tight`` (every internal box the exact join of its children's),
vectorized over the SoA arrays. They take a ``FlatBvh`` of numpy arrays or
of tensors on any device (read on the host) and return the reference's
messages.
"""

from __future__ import annotations

import numpy as np

import torch

from .flat import LEAF, FlatBvh


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def check_consistent(flat: FlatBvh, shape_min=None, shape_max=None) -> list[str]:
    """Returns a list of violations (empty == consistent)."""
    f = flat.to_host()
    n = f.num_nodes
    errs: list[str] = []
    if n == 0:
        return errs
    entry, exit_, shape, parent = f.entry, f.exit, f.shape, f.parent
    internal = entry != LEAF

    if n % 2 != 1:
        errs.append(f"node count {n} is not 2n-1")

    # DFS layout: left child of internal i is i+1.
    bad_left = internal & (entry != np.arange(n) + 1)
    if bad_left.any():
        errs.append(f"{bad_left.sum()} internal nodes whose entry != i+1")

    # Exit pointers must stay in (i, n].
    if ((exit_ <= np.arange(n)) | (exit_ > n)).any():
        errs.append("exit pointer out of range")

    # Parent links: children of i point back at i.
    left = entry[internal]
    right = exit_[left]
    parents = np.nonzero(internal)[0]
    ok_right = (right < n) & (right > 0)
    if not ok_right.all():
        errs.append("right child index out of range")
    else:
        if (parent[left] != parents).any() or (parent[right] != parents).any():
            errs.append("parent backlink mismatch")

    # Every node except the root must be some node's child; count coverage.
    if (parent[0] != -1) or (parent[1:] == -1).any():
        errs.append("root/parent sentinel wrong (detached subtree?)")

    # Shape indices at leaves form a permutation of 0..num_shapes-1.
    leaf_shapes = shape[~internal]
    ns = f.num_shapes
    if sorted(leaf_shapes.tolist()) != list(range(ns)):
        errs.append("leaf shape indices are not a permutation")
    if (shape[internal] != -1).any():
        errs.append("internal node carries a shape index")

    # Containment: child AABBs inside parent AABB.
    if ok_right.all() and internal.any():
        for child in (left, right):
            inside = (f.aabb_min[parents] <= f.aabb_min[child]).all(axis=-1) & (
                f.aabb_max[parents] >= f.aabb_max[child]
            ).all(axis=-1)
            if not inside.all():
                errs.append("child AABB escapes parent AABB")
                break

    # Leaf AABBs match the shapes they reference.
    if shape_min is not None:
        leaves = np.nonzero(~internal)[0]
        si = shape[leaves]
        if not (
            np.array_equal(f.aabb_min[leaves], _host(shape_min)[si])
            and np.array_equal(f.aabb_max[leaves], _host(shape_max)[si])
        ):
            errs.append("leaf AABB != shape AABB")
    return errs


def check_tight(flat: FlatBvh) -> list[str]:
    """Internal AABB must equal the join of its children exactly
    (min/max joins are associative, so exact equality is achievable —
    same contract as reference ``assert_tight``)."""
    f = flat.to_host()
    errs: list[str] = []
    internal = f.entry != LEAF
    if not internal.any():
        return errs
    parents = np.nonzero(internal)[0]
    left = f.entry[parents]
    right = f.exit[left]
    join_min = np.minimum(f.aabb_min[left], f.aabb_min[right])
    join_max = np.maximum(f.aabb_max[left], f.aabb_max[right])
    if not (
        np.array_equal(join_min, f.aabb_min[parents])
        and np.array_equal(join_max, f.aabb_max[parents])
    ):
        bad = (join_min != f.aabb_min[parents]).any(axis=-1) | (
            join_max != f.aabb_max[parents]
        ).any(axis=-1)
        errs.append(f"{bad.sum()} internal AABBs not tight")
    return errs


def assert_consistent(flat: FlatBvh, shape_min=None, shape_max=None) -> None:
    errs = check_consistent(flat, shape_min, shape_max)
    if errs:
        raise AssertionError("BVH inconsistent: " + "; ".join(errs))


def assert_tight(flat: FlatBvh) -> None:
    errs = check_tight(flat)
    if errs:
        raise AssertionError("BVH not tight: " + "; ".join(errs))
