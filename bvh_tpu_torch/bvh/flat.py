"""The flat, stackless BVH, in its host (numpy) or its tensor form.

Layout invariants (depth-first, as ``bvh_tpu/bvh/flat.py``):

* nodes are stored in DFS order: the left child of internal node ``i`` is
  ``i + 1``; the right child is ``exit[i + 1]``;
* ``entry[i]`` is the left-child index for internal nodes, ``LEAF`` (-1) for
  leaves;
* ``exit[i]`` is the skip pointer: the next DFS node after ``i``'s subtree;
  a walk ends when the cursor reaches ``num_nodes``;
* every node stores its own AABB; ``parent`` is -1 at the root.

A BVH over n shapes has exactly ``2n - 1`` nodes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

LEAF = -1  # entry value marking a leaf node


class FlatBvh(NamedTuple):
    """SoA node arrays: numpy (the host builders) or tensors (``to_device``,
    ``bvh/lbvh.py::build_lbvh``, ``bvh/refit.py``); the fields are the
    same."""

    aabb_min: np.ndarray  # [N, D] node AABB lower corner
    aabb_max: np.ndarray  # [N, D] node AABB upper corner
    entry: np.ndarray  # [N] i32 left-child index, or LEAF
    exit: np.ndarray  # [N] i32 skip pointer (N terminates)
    shape: np.ndarray  # [N] i32 shape index at leaves, -1 at internal nodes
    parent: np.ndarray  # [N] i32 parent index, -1 at root

    @property
    def num_nodes(self) -> int:
        return self.entry.shape[0]

    @property
    def num_shapes(self) -> int:
        return (self.num_nodes + 1) // 2

    @property
    def ndim_space(self) -> int:
        return self.aabb_min.shape[-1]

    def is_leaf(self):
        return self.entry == LEAF

    def right_child(self):
        """The right child of each internal node i, exit[i + 1] (DFS
        layout), as the arrays' type; leaves give exit[0]."""
        hi = max(self.num_nodes - 1, 0)
        if torch.is_tensor(self.entry):
            return self.exit[self.entry.clamp(0, hi).long()]
        return np.asarray(self.exit)[np.clip(np.asarray(self.entry), 0, hi)]

    def to_device(self, dtype=None, device=None) -> "FlatBvh":
        """The node arrays as tensors on ``device`` (None: the card);
        ``dtype`` converts the float fields."""
        dev = resolve_device(device)

        def conv(x):
            x = torch.as_tensor(x).to(dev)
            if dtype is not None and x.is_floating_point():
                x = x.to(dtype)
            return x

        return FlatBvh(*(conv(x) for x in self))

    def to_host(self) -> "FlatBvh":
        """The node arrays as numpy arrays."""
        return FlatBvh(*(x.cpu().numpy() if torch.is_tensor(x)
                         else np.asarray(x) for x in self))

    @staticmethod
    def empty(d: int = 3, dtype=np.float32) -> "FlatBvh":
        z = np.zeros((0, d), dtype)
        zi = np.zeros((0,), np.int32)
        return FlatBvh(z, z, zi, zi, zi, zi)

    def pretty_print(self, max_nodes: int = 64) -> str:
        """An indented dump of the tree, at most ``max_nodes`` lines."""
        h = self.to_host()
        n = h.num_nodes
        lines: list[str] = []

        def rec(i: int, depth: int):
            if i >= n or len(lines) >= max_nodes:
                return
            pad = "  " * depth
            if h.entry[i] == LEAF:
                lines.append(f"{pad}shape\t{h.shape[i]}")
            else:
                left = h.entry[i]
                lines.append(f"{pad}{np.round(h.aabb_min[i], 3)} "
                             f"{np.round(h.aabb_max[i], 3)}")
                rec(left, depth + 1)
                rec(h.exit[left], depth + 1)

        if n:
            rec(0, 0)
        return "\n".join(lines)
