"""Host-side pointer BVH with incremental (topology-editing) updates.

Counterpart of ``bvh_tpu/bvh/tree.py`` (numpy), over the port's own
``sah_build.py``; ``flatten`` gives a numpy ``FlatBvh`` whose arrays equal
the reference's, and ``FlatBvh.to_device`` puts it on the card.

The device path works on flat SoA arrays; this class is its host-side
companion for *dynamic scene maintenance*, mirroring the crate's ``Bvh``
semantics (``src/bvh/optimization.rs``): SAH-cost-guided insertion with a
merge-into-new-node option (``add_shape:70-209``, merge when
``merged < 0.3 * min_send``), removal by sibling promotion with swap-remove
keeping the node array dense (``remove_shape:214-301``),
``update_shapes`` = remove-all-then-reinsert-all (:304-315), and
``fix_aabbs_ascending`` walking boxes up only while they change (:317-351).

Layout note (matches the reference, transposed to SoA): child AABBs are
stored in the *parent* — arrays ``l_min/l_max/r_min/r_max`` — so an insert
only touches the descent path. ``flatten()`` emits the DFS entry/exit
``FlatBvh`` for device traversal. The root's parent is itself (index 0).
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_CONFIG, BvhConfig
from .flat import LEAF, FlatBvh
from .sah_build import build_sah


def _sa(mn, mx):
    s = mx - mn
    return np.float32(2.0) * np.float32(np.dot(s, s))


class Bvh:
    """Pointer BVH over shapes given by their AABBs (SoA numpy arrays)."""

    def __init__(self, shape_min, shape_max, config: BvhConfig = DEFAULT_CONFIG,
                 build: bool = True):
        self.shape_min = np.asarray(shape_min, np.float32).copy()
        self.shape_max = np.asarray(shape_max, np.float32).copy()
        self.config = config
        n = self.shape_min.shape[0]
        d = self.shape_min.shape[1] if n else 3
        self.d = d
        cap = max(2 * n + 8, 16)
        self.parent = np.zeros(cap, np.int64)
        self.left = np.full(cap, -1, np.int64)  # -1 == leaf
        self.right = np.full(cap, -1, np.int64)
        self.l_min = np.zeros((cap, d), np.float32)
        self.l_max = np.zeros((cap, d), np.float32)
        self.r_min = np.zeros((cap, d), np.float32)
        self.r_max = np.zeros((cap, d), np.float32)
        self.shape = np.full(cap, -1, np.int64)
        self.count = 0
        self.shape_to_node = np.full(n, -1, np.int64)
        if build and n:
            flat, s2n = build_sah(self.shape_min, self.shape_max, config)
            self._load_flat(flat, s2n)

    # -- construction ---------------------------------------------------------

    def _ensure(self, extra: int):
        need = self.count + extra
        if need <= self.parent.shape[0]:
            return
        cap = max(need, 2 * self.parent.shape[0])
        for name in ("parent", "left", "right", "shape"):
            arr = getattr(self, name)
            new = np.full(cap, -1 if name != "parent" else 0, arr.dtype)
            new[: self.count] = arr[: self.count]
            setattr(self, name, new)
        for name in ("l_min", "l_max", "r_min", "r_max"):
            arr = getattr(self, name)
            new = np.zeros((cap, self.d), np.float32)
            new[: self.count] = arr[: self.count]
            setattr(self, name, new)

    def _load_flat(self, flat: FlatBvh, s2n):
        f = flat.to_host()
        n = f.num_nodes
        self._ensure(n)
        self.count = n
        entry = f.entry.astype(np.int64)
        internal = entry != LEAF
        self.left[:n] = np.where(internal, entry, -1)
        right = np.where(internal, f.exit[np.clip(entry, 0, n - 1)], -1)
        self.right[:n] = right
        self.parent[:n] = np.maximum(f.parent, 0)
        self.shape[:n] = np.where(internal, -1, f.shape)
        li = np.clip(self.left[:n], 0, n - 1)
        ri = np.clip(right, 0, n - 1)
        self.l_min[:n] = f.aabb_min[li]
        self.l_max[:n] = f.aabb_max[li]
        self.r_min[:n] = f.aabb_min[ri]
        self.r_max[:n] = f.aabb_max[ri]
        self.shape_to_node = s2n.astype(np.int64).copy()

    # -- queries ----------------------------------------------------------------

    def is_leaf(self, i: int) -> bool:
        return self.left[i] < 0

    def node_aabb(self, i: int):
        """A node's own AABB: shape box at leaves, join of child boxes inside."""
        if self.is_leaf(i):
            s = self.shape[i]
            return self.shape_min[s].copy(), self.shape_max[s].copy()
        return (
            np.minimum(self.l_min[i], self.r_min[i]),
            np.maximum(self.l_max[i], self.r_max[i]),
        )

    # -- incremental updates ------------------------------------------------------

    def add_shape(self, new_shape_index: int):
        """SAH-cost-guided insertion (reference add_shape semantics)."""
        mn = self.shape_min[new_shape_index]
        mx = self.shape_max[new_shape_index]
        shape_sa = _sa(mn, mx)
        if new_shape_index >= self.shape_to_node.shape[0]:
            grow = np.full(new_shape_index + 1 - self.shape_to_node.shape[0], -1, np.int64)
            self.shape_to_node = np.concatenate([self.shape_to_node, grow])

        if self.count == 0:
            self._ensure(1)
            self.parent[0] = 0
            self.left[0] = -1
            self.shape[0] = new_shape_index
            self.count = 1
            self.shape_to_node[new_shape_index] = 0
            return

        node = 0
        while True:
            if not self.is_leaf(node):
                l_mn, l_mx = self.l_min[node], self.l_max[node]
                r_mn, r_mx = self.r_min[node], self.r_max[node]
                le_mn, le_mx = np.minimum(l_mn, mn), np.maximum(l_mx, mx)
                re_mn, re_mx = np.minimum(r_mn, mn), np.maximum(r_mx, mx)
                send_left = _sa(r_mn, r_mx) + _sa(le_mn, le_mx)
                send_right = _sa(l_mn, l_mx) + _sa(re_mn, re_mx)
                mg_mn, mg_mx = np.minimum(l_mn, r_mn), np.maximum(l_mx, r_mx)
                merged = _sa(mg_mn, mg_mx) + shape_sa
                min_send = min(send_left, send_right)

                if merged < min_send * np.float32(self.config.merge_threshold):
                    # new leaf on the left, old children pushed under a new
                    # right node
                    self._ensure(2)
                    l_index = self.count
                    r_index = self.count + 1
                    self.count += 2
                    self.parent[l_index] = node
                    self.left[l_index] = -1
                    self.shape[l_index] = new_shape_index
                    self.shape_to_node[new_shape_index] = l_index

                    self.parent[r_index] = node
                    self.left[r_index] = self.left[node]
                    self.right[r_index] = self.right[node]
                    self.l_min[r_index] = l_mn.copy()
                    self.l_max[r_index] = l_mx.copy()
                    self.r_min[r_index] = r_mn.copy()
                    self.r_max[r_index] = r_mx.copy()
                    self.shape[r_index] = -1
                    self.parent[self.left[node]] = r_index
                    self.parent[self.right[node]] = r_index

                    self.left[node] = l_index
                    self.right[node] = r_index
                    self.l_min[node] = mn.copy()
                    self.l_max[node] = mx.copy()
                    self.r_min[node] = mg_mn
                    self.r_max[node] = mg_mx
                    return
                elif send_left < send_right:
                    self.l_min[node] = le_mn
                    self.l_max[node] = le_mx
                    node = self.left[node]
                else:
                    self.r_min[node] = re_mn
                    self.r_max[node] = re_mx
                    node = self.right[node]
            else:
                # split this leaf: new shape goes left, old shape goes right
                old_shape = self.shape[node]
                self._ensure(2)
                l_index = self.count
                r_index = self.count + 1
                self.count += 2
                self.parent[l_index] = node
                self.left[l_index] = -1
                self.shape[l_index] = new_shape_index
                self.shape_to_node[new_shape_index] = l_index
                self.parent[r_index] = node
                self.left[r_index] = -1
                self.shape[r_index] = old_shape
                self.shape_to_node[old_shape] = r_index

                self.left[node] = l_index
                self.right[node] = r_index
                self.l_min[node] = mn.copy()
                self.l_max[node] = mx.copy()
                self.r_min[node] = self.shape_min[old_shape].copy()
                self.r_max[node] = self.shape_max[old_shape].copy()
                self.shape[node] = -1
                self._fix_aabbs_ascending(self.parent[node] if node != 0 else 0)
                return

    def _connect(self, child: int, parent: int, as_left: bool):
        mn, mx = self.node_aabb(child)
        if as_left:
            self.left[parent] = child
            self.l_min[parent] = mn
            self.l_max[parent] = mx
        else:
            self.right[parent] = child
            self.r_min[parent] = mn
            self.r_max[parent] = mx
        self.parent[child] = parent

    def remove_shape(self, deleted_shape_index: int):
        """Sibling-promotion removal (reference remove_shape semantics)."""
        if self.count == 0:
            raise ValueError("empty BVH")
        dead = self.shape_to_node[deleted_shape_index]
        assert self.is_leaf(dead)
        if self.count == 1:
            assert dead == 0
            self.count = 0
            self.shape_to_node[deleted_shape_index] = -1
            return

        par = self.parent[dead]
        gp = self.parent[par]
        sibling = self.right[par] if self.left[par] == dead else self.left[par]

        if par == gp:
            # parent is the root: sibling becomes the root
            assert par == 0
            if not self.is_leaf(sibling):
                sl, sr = self.left[sibling], self.right[sibling]
                self.left[0] = sl
                self.right[0] = sr
                self.l_min[0] = self.l_min[sibling].copy()
                self.l_max[0] = self.l_max[sibling].copy()
                self.r_min[0] = self.r_min[sibling].copy()
                self.r_max[0] = self.r_max[sibling].copy()
                self.shape[0] = -1
                self.parent[sl] = 0
                self.parent[sr] = 0
            else:
                self.left[0] = -1
                self.right[0] = -1
                self.shape[0] = self.shape[sibling]
                self.shape_to_node[self.shape[sibling]] = 0
            self.parent[0] = 0
            self._swap_remove(max(sibling, dead))
            self._swap_remove(min(sibling, dead))
        else:
            parent_is_left = self.left[gp] == par
            self._connect(sibling, gp, parent_is_left)
            self._fix_aabbs_ascending(gp)
            self._swap_remove(max(dead, par))
            self._swap_remove(min(dead, par))
        self.shape_to_node[deleted_shape_index] = -1

    def update_shapes(self, changed_indices, new_shape_min=None, new_shape_max=None):
        """Remove-then-reinsert every changed shape (reference contract).

        Like the reference, shapes are assumed to have ALREADY moved when the
        update runs (``randomly_transform_scene`` mutates first) — so new
        boxes are applied before any tree surgery.
        """
        changed = list(changed_indices)
        if new_shape_min is not None:
            self.shape_min[changed] = np.asarray(new_shape_min, np.float32)
            self.shape_max[changed] = np.asarray(new_shape_max, np.float32)
        for i in changed:
            self.remove_shape(i)
        for i in changed:
            self.add_shape(i)

    def _fix_aabbs_ascending(self, node_index: int):
        i = int(node_index)
        while i != 0:
            p = self.parent[i]
            li, ri = self.left[p], self.right[p]
            l_mn, l_mx = self.node_aabb(li)
            r_mn, r_mx = self.node_aabb(ri)
            stop = True
            if not (np.array_equal(l_mn, self.l_min[p]) and np.array_equal(l_mx, self.l_max[p])):
                stop = False
                self.l_min[p] = l_mn
                self.l_max[p] = l_mx
            if not (np.array_equal(r_mn, self.r_min[p]) and np.array_equal(r_mx, self.r_max[p])):
                stop = False
                self.r_min[p] = r_mn
                self.r_max[p] = r_mx
            i = p if not stop else 0

    def _swap_remove(self, node_index: int):
        end = self.count - 1
        i = int(node_index)
        if i != end:
            # move the last node into slot i and rewire
            for name in ("parent", "left", "right", "shape"):
                getattr(self, name)[i] = getattr(self, name)[end]
            for name in ("l_min", "l_max", "r_min", "r_max"):
                getattr(self, name)[i] = getattr(self, name)[end]
            p = self.parent[i]
            if self.left[p] == end:
                self.left[p] = i
            else:
                assert self.right[p] == end
                self.right[p] = i
            if self.is_leaf(i):
                self.shape_to_node[self.shape[i]] = i
            else:
                self.parent[self.left[i]] = i
                self.parent[self.right[i]] = i
        self.count = end

    # -- export / checks ----------------------------------------------------------

    def flatten(self) -> tuple:
        """DFS flatten to the device ``FlatBvh`` layout. Returns (flat, s2n)."""
        n = self.count
        if n == 0:
            return FlatBvh.empty(self.d), np.zeros(0, np.int32)
        amin = np.zeros((n, self.d), np.float32)
        amax = np.zeros((n, self.d), np.float32)
        entry = np.full(n, LEAF, np.int32)
        exit_ = np.zeros(n, np.int32)
        shape = np.full(n, -1, np.int32)
        parent = np.full(n, -1, np.int32)
        s2n = np.full(self.shape_to_node.shape[0], -1, np.int32)

        # iterative DFS: (old_index, new_parent, exit_target)
        leaf_counts = self._leaf_counts()
        cursor = 0
        stack = [(0, -1, n)]
        while stack:
            old, new_parent, ex = stack.pop()
            new = cursor
            cursor += 1
            parent[new] = new_parent
            exit_[new] = ex
            mn, mx = self.node_aabb(old)
            amin[new] = mn
            amax[new] = mx
            if self.is_leaf(old):
                shape[new] = self.shape[old]
                s2n[self.shape[old]] = new
            else:
                entry[new] = new + 1
                # right child starts after the whole left subtree (full binary
                # tree: a subtree with L leaves has 2L-1 nodes)
                right_start = new + 1 + 2 * leaf_counts[self.left[old]] - 1
                stack.append((self.right[old], new, ex))
                stack.append((self.left[old], new, right_start))
        flat = FlatBvh(amin, amax, entry, exit_, shape, parent)
        return flat, s2n

    def _leaf_counts(self) -> np.ndarray:
        """Leaves under every node, via one post-order accumulation pass."""
        n = self.count
        counts = np.zeros(n, np.int64)
        post = []
        stack = [0]
        while stack:
            i = stack.pop()
            post.append(i)
            if not self.is_leaf(i):
                stack.append(int(self.left[i]))
                stack.append(int(self.right[i]))
        for i in reversed(post):
            counts[i] = 1 if self.is_leaf(i) else counts[self.left[i]] + counts[self.right[i]]
        return counts

    def assert_consistent(self):
        """Parent links, reachability, containment (reference :280-443)."""
        n = self.count
        if n == 0:
            return
        seen = np.zeros(n, bool)
        stack = [0]
        while stack:
            i = stack.pop()
            assert 0 <= i < n, f"node {i} out of bounds"
            assert not seen[i], f"node {i} visited twice (cycle)"
            seen[i] = True
            if not self.is_leaf(i):
                l, r = int(self.left[i]), int(self.right[i])
                assert self.parent[l] == i and self.parent[r] == i, "parent backlink broken"
                for child, c_mn, c_mx in ((l, self.l_min[i], self.l_max[i]),
                                          (r, self.r_min[i], self.r_max[i])):
                    mn, mx = self.node_aabb(child)
                    assert np.all(mn >= c_mn - 1e-4) and np.all(mx <= c_mx + 1e-4), (
                        f"child {child} escapes stored box"
                    )
                stack += [l, r]
            else:
                s = int(self.shape[i])
                assert self.shape_to_node[s] == i, "shape backlink broken"
        assert seen.all(), "detached subtree"

    def assert_tight(self):
        """Stored child boxes equal the children's exact AABBs."""
        for i in range(self.count):
            if self.is_leaf(i):
                continue
            l_mn, l_mx = self.node_aabb(int(self.left[i]))
            r_mn, r_mx = self.node_aabb(int(self.right[i]))
            assert np.array_equal(l_mn, self.l_min[i]) and np.array_equal(l_mx, self.l_max[i]), i
            assert np.array_equal(r_mn, self.r_min[i]) and np.array_equal(r_mx, self.r_max[i]), i
