"""The port's host pointer tree (``bvh_tpu_torch/bvh/tree.py::Bvh``)
against bvh_tpu's under the same seeded sequences of ``add_shape``,
``remove_shape`` and ``update_shapes`` (the cases of
``tests/test_refit_tree.py``): the node arrays and ``flatten`` array-equal
to the reference's after every step, the checks passing, and the
flattened tree's closest hits (the port's general path) within rtol 1e-6
of brute force.
"""

import numpy as np
import pytest
import torch

from bvh_tpu.bvh.tree import Bvh as Bvh_j
from bvh_tpu_torch import Ray
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.bvh import (Bvh, assert_consistent, assert_tight,
                               brute_force_closest_hit, closest_hit_triangles)
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
FIELDS = ("parent", "left", "right", "l_min", "l_max", "r_min", "r_max",
          "shape", "shape_to_node")


def assert_trees_equal(tj, tt):
    """The two trees' live node arrays and their flattened forms equal."""
    assert tt.count == tj.count
    n = tt.count
    for name in FIELDS:
        x, y = getattr(tj, name), getattr(tt, name)
        if name != "shape_to_node":
            x, y = x[:n], y[:n]
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    (fj, sj), (ft, st) = tj.flatten(), tt.flatten()
    for x, y in zip(fj, ft):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(sj, st)


def moved_scene(n_cubes=50, frac=0.5, seed=99):
    a, b, c = tb.create_n_cubes(n_cubes)
    n = a.shape[0]
    a2, b2, c2, idx = tb.randomly_transform_scene(a, b, c, int(n * frac),
                                                  seed=seed)
    return (a, b, c), (a2, b2, c2), idx


def test_tree_add_remove_roundtrip():
    a, b, c = tb.create_n_cubes(10)
    mn, mx = tb.tri_aabbs(a, b, c)
    tj, tt = Bvh_j(mn, mx), Bvh(mn, mx)
    assert_trees_equal(tj, tt)
    tt.assert_consistent()
    tt.assert_tight()
    n = mn.shape[0]
    removed = list(range(0, n, 3))
    for i in removed:
        tj.remove_shape(i)
        tt.remove_shape(i)
        assert_trees_equal(tj, tt)
    tt.assert_consistent()
    for i in removed:
        tj.add_shape(i)
        tt.add_shape(i)
    assert_trees_equal(tj, tt)
    tt.assert_consistent()
    tt.assert_tight()
    assert tt.count == 2 * n - 1


def test_tree_seeded_sequence():
    """One seeded sequence of removals, additions and updates of moved
    boxes, array-equal to the reference's after every call."""
    (a, b, c), (a2, b2, c2), _ = moved_scene(30, 0.5, seed=5)
    mn, mx = tb.tri_aabbs(a, b, c)
    mn2, mx2 = tb.tri_aabbs(a2, b2, c2)
    tj, tt = Bvh_j(mn, mx), Bvh(mn, mx)
    rng = np.random.default_rng(17)
    out = []
    for step in range(40):
        op = rng.integers(0, 3)
        if op == 0 and len(out) < mn.shape[0] - 2:
            i = int(rng.choice(np.setdiff1d(np.arange(mn.shape[0]), out)))
            tj.remove_shape(i)
            tt.remove_shape(i)
            out.append(i)
        elif op == 1 and out:
            i = out.pop(int(rng.integers(0, len(out))))
            tj.add_shape(i)
            tt.add_shape(i)
        else:
            live = np.setdiff1d(np.arange(mn.shape[0]), out)
            idx = rng.choice(live, size=min(5, len(live)), replace=False)
            tj.update_shapes(idx.tolist(), mn2[idx], mx2[idx])
            tt.update_shapes(idx.tolist(), mn2[idx], mx2[idx])
        assert_trees_equal(tj, tt)
    tt.assert_consistent()
    tt.assert_tight()


def test_tree_update_shapes_like_reference_bench():
    """Move 75% of 1,200 triangles, update, verify, and trace the flattened
    tree with the port's general path against brute force."""
    (a, b, c), (a2, b2, c2), idx = moved_scene(100, 0.75)
    mn, mx = tb.tri_aabbs(a, b, c)
    mn2, mx2 = tb.tri_aabbs(a2, b2, c2)
    tj, tt = Bvh_j(mn, mx), Bvh(mn, mx)
    tj.update_shapes(idx.tolist(), mn2[idx], mx2[idx])
    tt.update_shapes(idx.tolist(), mn2[idx], mx2[idx])
    assert_trees_equal(tj, tt)
    tt.assert_consistent()
    tt.assert_tight()
    flat, _ = tt.flatten()
    assert_consistent(flat, mn2, mx2)
    assert_tight(flat)
    centers = a2.reshape(-1, 12, 3).mean(axis=1)[:64]
    origins = (centers + np.array([900.0, -400.0, 600.0], np.float32)
               ).astype(np.float32)
    aim = centers + np.array([0.11, 0.07, -0.13], np.float32)
    rays = Ray.create(origins, (aim - origins).astype(np.float32), device=CPU)
    tris = tuple(torch.from_numpy(x) for x in (a2, b2, c2))
    got = closest_hit_triangles(flat.to_device(device=CPU), rays, *tris)
    want = brute_force_closest_hit(rays, *tris)
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), rtol=1e-6)


def test_tree_remove_all_then_rebuild():
    mn = np.arange(12, dtype=np.float32).reshape(4, 3)
    mx = mn + 1.0
    tj, tt = Bvh_j(mn, mx), Bvh(mn, mx)
    for i in range(4):
        tj.remove_shape(i)
        tt.remove_shape(i)
    assert tt.count == 0
    for i in range(4):
        tj.add_shape(i)
        tt.add_shape(i)
    assert_trees_equal(tj, tt)
    tt.assert_consistent()
    tt.assert_tight()
    assert tt.count == 7


def test_tree_single_and_empty():
    t = Bvh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))
    assert t.count == 0
    flat, s2n = t.flatten()
    assert flat.num_nodes == 0 and s2n.shape == (0,)
    t2 = Bvh(np.zeros((1, 3), np.float32), np.ones((1, 3), np.float32))
    assert t2.count == 1
    t2.remove_shape(0)
    assert t2.count == 0
    with pytest.raises(ValueError, match="empty"):
        t2.remove_shape(0)
