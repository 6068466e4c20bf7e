"""The port's host scene build against bvh_tpu: every TightScene field
array-equal (``equal_nan`` for the NaN-padded wide table), for the native
and the numpy build and every leaf width; and a bvh_tpu-built scene carried
across with ``scene_from_arrays``."""

import numpy as np
import pytest

from bvh_tpu import testbase as tb_j
from bvh_tpu.io.serialize import save_tight_scene
from bvh_tpu.ops.cluster import build_tight_scene as build_j
from bvh_tpu.ops.cluster import collapse_upper as collapse_j
from bvh_tpu_torch import testbase as tb_t
from bvh_tpu_torch.bvh.sah_build import build_sah
from bvh_tpu_torch.native import build_sah_native
from bvh_tpu_torch.ops.cluster import (TightScene, build_tight_scene,
                                       collapse_upper, scene_from_arrays)


def _assert_scene_equal(sj, st):
    assert type(st) is TightScene
    assert st._fields == sj._fields
    for name in sj._fields:
        x, y = getattr(sj, name), getattr(st, name)
        if x is None or y is None:
            assert x is None and y is None, name
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert np.array_equal(x, y, equal_nan=(name == "gnodes")), name
        else:
            assert x == y, name


@pytest.fixture(scope="module")
def cubes():
    return tb_t.create_n_cubes(200)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("leaf_size", [None, 16, 32, 64, 128])
def test_build_tight_scene_equal(cubes, use_native, leaf_size):
    a, b, c = cubes
    sj = build_j(a, b, c, leaf_size=leaf_size, use_native=use_native)
    st = build_tight_scene(a, b, c, leaf_size=leaf_size, use_native=use_native)
    assert st.gnodes is not None
    _assert_scene_equal(sj, st)


@pytest.mark.parametrize("use_native", [True, False])
def test_build_dense_mesh_equal(use_native):
    a, b, c = tb_t.create_dense_mesh(40)
    sj = build_j(a, b, c, leaf_size=64, use_native=use_native)
    st = build_tight_scene(a, b, c, leaf_size=64, use_native=use_native)
    _assert_scene_equal(sj, st)


@pytest.mark.parametrize("kwargs", [{"collapse": None}, {"wide": False},
                                    {"collapse": 8}])
def test_build_options_equal(cubes, kwargs):
    a, b, c = cubes
    for use_native in (True, False):
        _assert_scene_equal(build_j(a, b, c, use_native=use_native, **kwargs),
                            build_tight_scene(a, b, c, use_native=use_native,
                                              **kwargs))


def test_single_cluster_scene_equal():
    a, b, c = tb_t.create_n_cubes(1)  # 12 triangles: one leaf cluster
    for use_native in (True, False):
        sj = build_j(a, b, c, use_native=use_native)
        st = build_tight_scene(a, b, c, use_native=use_native)
        assert st.num_clusters == 1 and st.gdepth == 1
        _assert_scene_equal(sj, st)


def test_native_sah_matches_numpy(cubes):
    a, b, c = cubes
    mn, mx = tb_t.tri_aabbs(a, b, c)
    fn, _ = build_sah_native(mn, mx)
    fp, _ = build_sah(mn, mx)
    for x, y in zip(fn, fp):
        assert np.array_equal(x, y)


def test_collapse_native_and_numpy_equal(cubes):
    a, b, c = cubes
    mn, mx = tb_t.tri_aabbs(a, b, c)
    flat, _ = build_sah(mn, mx)
    tab = np.zeros((8, flat.num_nodes), np.float32)
    tab[0:3], tab[3:6] = flat.aabb_min.T, flat.aabb_max.T
    tab[6] = np.where(flat.entry < 0, -(flat.shape + 1.0), flat.entry)
    tab[7] = flat.exit
    ref = collapse_j(tab, 16)
    assert np.array_equal(collapse_upper(tab, 16, use_native=True), ref)
    assert np.array_equal(collapse_upper(tab, 16, use_native=False), ref)


@pytest.mark.parametrize("kwargs", [{"packed": True}, {"bmat": True},
                                    {"sweep_cut": 64}])
def test_unported_options_raise(cubes, kwargs):
    """The options that raised before the entry/exit walk was ported now
    build their extra table, array-equal to the reference's."""
    a, b, c = cubes
    st = build_tight_scene(a, b, c, **kwargs)
    extra = {"packed": "packed_nodes", "bmat": "bgroups",
             "sweep_cut": "sweep_nodes"}[next(iter(kwargs))]
    assert getattr(st, extra) is not None
    assert (st.gnodes is None) == ("packed" in kwargs)
    _assert_scene_equal(build_j(a, b, c, **kwargs), st)


def test_scene_from_asdict(cubes):
    a, b, c = cubes
    sj = build_j(a, b, c)
    _assert_scene_equal(sj, scene_from_arrays(sj._asdict()))


def test_scene_from_npz(cubes, tmp_path):
    a, b, c = cubes
    sj = build_j(a, b, c, leaf_size=32)
    path = tmp_path / "scene.npz"
    save_tight_scene(str(path), sj)
    with np.load(path) as z:
        st = scene_from_arrays(z)
    assert isinstance(st.num_nodes, int) and isinstance(st.gdepth, int)
    _assert_scene_equal(sj, st)
    _assert_scene_equal(build_tight_scene(a, b, c, leaf_size=32), st)


def test_scene_from_arrays_rejects():
    a, b, c = tb_j.create_n_cubes(10)
    fields = build_j(a, b, c)._asdict()
    with pytest.raises(ValueError, match="newer"):
        scene_from_arrays({**fields, "__tight_version__": np.int64(99)})
    with pytest.raises(ValueError, match="not TightScene fields"):
        scene_from_arrays({**fields, "bogus": np.zeros(1)})
