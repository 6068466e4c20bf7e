"""The port's native binding (``bvh_tpu_torch/native.py``) against the
reference's (``bvh_tpu/native.py``) on the same seeded inputs.

* ``build_sah_auto``: FlatBvh and shape -> node map array-equal (dtype,
  shape, every value) to the reference's on float32 3-D boxes (the native
  build), on float64 boxes and on 2-D boxes (both the numpy build), and
  with a cluster hint.
* ``build_sah_native``: ``nthreads`` at the reference's position (the third
  argument) and the tree independent of it.
* ``native_available``: True where the library builds; False, without
  raising, where it cannot load; ``build_sah_auto`` then takes the numpy
  build, whose tree is the native one.
"""

import inspect

import numpy as np
import pytest

import bvh_tpu.native as native_j
from bvh_tpu_torch import native as native_t
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.bvh import build_sah
from test_torch_scene import reference_native  # noqa: F401  (autouse)


def _boxes(n_cubes: int, seed: int = 0):
    return tb.tri_aabbs(*tb.create_n_cubes(n_cubes, seed=seed))


def _random_boxes(n: int, d: int, dtype, seed: int):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-100.0, 100.0, (n, d))
    return lo.astype(dtype), (lo + rng.uniform(0.0, 3.0, (n, d))).astype(dtype)


def assert_tree_equal(got, want) -> None:
    """Two ``(FlatBvh, shape_to_node)`` pairs array-equal, dtypes included."""
    (f1, s1), (f2, s2) = got, want
    for name in f2._fields:
        x, y = np.asarray(getattr(f1, name)), np.asarray(getattr(f2, name))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(x, y), name
    assert np.asarray(s1).dtype == np.asarray(s2).dtype
    assert np.array_equal(np.asarray(s1), np.asarray(s2))


@pytest.mark.parametrize("n_cubes", [1, 7, 64, 300])
def test_build_sah_auto_float32_native(n_cubes):
    mn, mx = _boxes(n_cubes, seed=n_cubes)
    assert mn.dtype == np.float32
    assert_tree_equal(native_t.build_sah_auto(mn, mx),
                      native_j.build_sah_auto(mn, mx))


@pytest.mark.parametrize("case", ["float64_3d", "float32_2d", "float64_2d",
                                  "float32_4d"])
def test_build_sah_auto_numpy_cases(case):
    """Boxes the native builder does not take: the numpy build in both
    packages, float64 kept."""
    dtype = np.float64 if case.startswith("float64") else np.float32
    d = int(case[-2])
    mn, mx = _random_boxes(200, d, dtype, seed=d)
    got = native_t.build_sah_auto(mn, mx)
    assert got[0].aabb_min.dtype == dtype
    assert_tree_equal(got, native_j.build_sah_auto(mn, mx))
    assert_tree_equal(got, build_sah(mn, mx))


def test_build_sah_auto_cluster_hint():
    mn, mx = _boxes(120, seed=3)
    got = native_t.build_sah_auto(mn, mx, cluster_hint=16)
    assert_tree_equal(got, native_j.build_sah_auto(mn, mx, cluster_hint=16))
    assert_tree_equal(got, native_t.build_sah_native(mn, mx,
                                                     cluster_hint=16))


def test_nthreads_is_the_third_argument():
    """The reference's signature; a third positional argument is the thread
    count, so the exact tree comes back (the hint build's differs)."""
    names = list(inspect.signature(native_t.build_sah_native).parameters)
    assert names == list(inspect.signature(
        native_j.build_sah_native).parameters)
    assert names[2] == "nthreads"
    assert list(inspect.signature(native_t.build_sah_auto).parameters) == \
        list(inspect.signature(native_j.build_sah_auto).parameters)
    mn, mx = _boxes(120, seed=3)
    exact = native_t.build_sah_native(mn, mx)
    assert_tree_equal(native_t.build_sah_native(mn, mx, 16), exact)
    hinted = native_t.build_sah_native(mn, mx, cluster_hint=16)
    assert not np.array_equal(hinted[0].shape, exact[0].shape)


@pytest.mark.parametrize("nthreads", [1, 2, 0])
def test_nthreads_gives_the_same_tree(nthreads):
    mn, mx = _boxes(300, seed=5)
    got = native_t.build_sah_native(mn, mx, nthreads)
    assert_tree_equal(got, native_t.build_sah_native(mn, mx, nthreads=0))
    assert_tree_equal(got, native_j.build_sah_native(mn, mx, nthreads))


def test_native_available_without_library(monkeypatch):
    """A library that cannot load: ``native_available`` is False and does
    not raise, and ``build_sah_auto`` takes the numpy build (the same
    tree)."""
    assert native_t.native_available()

    def broken():
        raise RuntimeError("building bvhbuild failed")

    native_t.native_available.cache_clear()
    monkeypatch.setattr(native_t, "load", broken)
    try:
        assert native_t.native_available() is False
        mn, mx = _boxes(64, seed=2)
        assert_tree_equal(native_t.build_sah_auto(mn, mx), build_sah(mn, mx))
        assert_tree_equal(native_t.build_sah_auto(mn, mx),
                          native_j.build_sah_auto(mn, mx))
    finally:
        native_t.native_available.cache_clear()
    monkeypatch.undo()
    assert native_t.native_available()


def test_build_sah_auto_empty():
    z = np.zeros((0, 3), np.float32)
    flat, s2n = native_t.build_sah_auto(z, z)
    assert flat.num_nodes == 0 and s2n.shape == (0,)
