"""The port's host scene build against bvh_tpu: every TightScene field
array-equal (``equal_nan`` for the NaN-padded wide table), for the native
and the numpy build and every leaf width; and a bvh_tpu-built scene carried
across with ``scene_from_arrays``. The port's own field, the exact-frame
table ``a_lo``, is held to the float64 remainder ``exact_a_lo`` on a port
build and to zeros on a scene carried over from the reference's arrays.

The reference's native builder (``bvh_tpu/native.py``) builds
``csrc/libbvhbuild.so`` with ``make`` on first use and, on any failure,
keeps its numpy fallback for the life of the process. That fallback orders
the lanes of a cluster differently from the native build (it ignores the
cluster hint), so a port build with ``use_native=True`` would no longer
equal the reference's. Under ``pytest -n``, every worker imports
``tests/test_native.py``, which loads the library at import, so in a fresh
checkout several workers run ``make`` on the same output at once, and one
that loses the race keeps the fallback. ``reference_native`` (module-scoped,
autouse; imported by every ``tests/test_torch_*.py`` that compares a
``use_native=True`` build with the reference's) takes that state away: under
one file lock for all workers it builds the library if it is missing and
reloads the reference's binding if it failed, and fails the tests of the
module, naming the cause, if the library still does not load. It never
skips and never falls back to ``use_native=False``.
"""

import fcntl
import os
import subprocess
import tempfile

import numpy as np
import pytest

from bvh_tpu import native as native_j
from bvh_tpu import testbase as tb_j
from bvh_tpu.io.serialize import save_tight_scene
from bvh_tpu.ops.cluster import build_tight_scene as build_j
from bvh_tpu.ops.cluster import collapse_upper as collapse_j
from bvh_tpu_torch import testbase as tb_t
from bvh_tpu_torch.bvh.sah_build import build_sah
from bvh_tpu_torch.native import build_sah_native
from bvh_tpu_torch.ops.cluster import (TightScene, build_tight_scene,
                                       collapse_upper, scene_from_arrays)


# one lock for every worker and every checkout on the machine: makes of two
# checkouts write to different files, so this only serialises them
NATIVE_LOCK = os.path.join(tempfile.gettempdir(), "bvh_tpu_native_build.lock")


def load_reference_native() -> None:
    """Makes sure ``bvh_tpu.native`` has its native library loaded in this
    process: under ``NATIVE_LOCK`` it runs ``make`` in the reference's
    source directory if ``libbvhbuild.so`` is missing there, and if the
    binding has no library (a failed or raced first load), resets its
    cache and loads again. Fails, naming the cause, if it still has none."""
    made = None
    with open(NATIVE_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        src = native_j._find_src_dir()
        if os.path.isdir(src) and not os.path.exists(
                os.path.join(src, "libbvhbuild.so")):
            try:
                made = subprocess.run(["make", "-C", src],
                                      capture_output=True, text=True,
                                      timeout=300)
            except (OSError, subprocess.SubprocessError) as err:
                made = err
        if not native_j.native_available():
            native_j._SRC_DIR = src
            native_j._LIB = None
            native_j._TRIED = False
            native_j._load()
    if native_j.native_available():
        return
    if not os.path.isdir(src):
        cause = f"its source directory {src} does not exist"
    elif isinstance(made, Exception):
        cause = f"make -C {src} did not run: {made}"
    elif made is not None and made.returncode != 0:
        cause = (f"make -C {src} failed (exit {made.returncode}):\n"
                 f"{made.stderr[-2000:]}")
    else:
        cause = f"{src}/libbvhbuild.so does not load"
    pytest.fail("bvh_tpu's native builder is unavailable, so its builds "
                f"fall back to numpy and cannot be compared: {cause}",
                pytrace=False)


@pytest.fixture(scope="module", autouse=True)
def reference_native():
    """The reference's native builder, loaded (``load_reference_native``)."""
    load_reference_native()


def exact_a_lo(scene, a, tri_map=None) -> np.ndarray:
    """The exact-frame table a port scene over vertices ``a`` must carry:
    ``(a - cc) - a'`` of every lane of ``tri_map`` (lane -> row of ``a``,
    -1 in pad lanes; default the scene's), in float64 rounded once to
    float32, with cc the frame origin the walks read at the cluster's leaf
    column (the box centre in float32, or a packed scene's raw packed-row
    value) and a' the stored row; 0 in pad lanes; [G, 3, 128]."""
    sn, W = np.asarray(scene.smem_nodes), int(scene.width)
    leaf = sn[6] < 0
    col = np.zeros(int(scene.num_clusters), np.int64)
    col[(-sn[6, leaf] - 1).astype(np.int64)] = np.nonzero(leaf)[0]
    if scene.packed_nodes is not None:
        cc = np.asarray(scene.packed_nodes)[0:3, col].T
    else:
        cc = (sn[0:3, col] + sn[3:6, col]).T * np.float32(0.5)
    groups = np.asarray(scene.groups)
    tm = np.asarray(scene.tri_map if tri_map is None else tri_map)
    G = groups.shape[0]
    rows = groups.transpose(0, 2, 1).reshape(G * 128, 16)
    lanes = np.nonzero(tm >= 0)[0]
    want = np.zeros((G * 128, 3), np.float32)
    want[lanes] = ((a[tm[lanes]].astype(np.float64) - cc[lanes // W])
                   - rows[lanes, 0:3]).astype(np.float32)
    return want.reshape(G, 128, 3).transpose(0, 2, 1)


def assert_a_lo(st, a=None):
    """``st.a_lo`` is [G, 3, 128] float32: ``exact_a_lo(st, a)`` for a port
    build over vertices ``a``, zeros (``a`` None) for a scene carried over
    from the reference's arrays, which hold no vertices."""
    want = (np.zeros((st.groups.shape[0], 3, 128), np.float32) if a is None
            else exact_a_lo(st, a))
    got = np.asarray(st.a_lo)
    assert got.dtype == np.float32 and np.array_equal(got, want)


def _assert_scene_equal(sj, st, a=None):
    """Every field of the reference's scene ``sj`` equal in the port's
    ``st``, and ``st.a_lo`` as ``assert_a_lo(st, a)`` says."""
    assert type(st) is TightScene
    ref = tuple(f for f in sj._fields if f != "a_lo")
    assert st._fields == ref + ("a_lo",)
    assert_a_lo(st, a)
    for name in ref:
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
    _assert_scene_equal(sj, st, a)


@pytest.mark.parametrize("use_native", [True, False])
def test_build_dense_mesh_equal(use_native):
    a, b, c = tb_t.create_dense_mesh(40)
    sj = build_j(a, b, c, leaf_size=64, use_native=use_native)
    st = build_tight_scene(a, b, c, leaf_size=64, use_native=use_native)
    _assert_scene_equal(sj, st, a)


@pytest.mark.parametrize("kwargs", [{"collapse": None}, {"wide": False},
                                    {"collapse": 8}])
def test_build_options_equal(cubes, kwargs):
    a, b, c = cubes
    for use_native in (True, False):
        _assert_scene_equal(build_j(a, b, c, use_native=use_native, **kwargs),
                            build_tight_scene(a, b, c, use_native=use_native,
                                              **kwargs), a)


def test_single_cluster_scene_equal():
    a, b, c = tb_t.create_n_cubes(1)  # 12 triangles: one leaf cluster
    for use_native in (True, False):
        sj = build_j(a, b, c, use_native=use_native)
        st = build_tight_scene(a, b, c, use_native=use_native)
        assert st.num_clusters == 1 and st.gdepth == 1
        _assert_scene_equal(sj, st, a)


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
    _assert_scene_equal(build_j(a, b, c, **kwargs), st, a)


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


def test_reference_native_recovers_from_a_failed_load(cubes, monkeypatch):
    """A worker whose first load of the reference's library failed (the
    binding cached None) gets it back, and its native build equals the
    port's again."""
    monkeypatch.setattr(native_j, "_LIB", None)
    monkeypatch.setattr(native_j, "_TRIED", True)
    assert not native_j.native_available()
    load_reference_native()
    assert native_j._LIB is not None and native_j.native_available()
    a, b, c = cubes
    _assert_scene_equal(build_j(a, b, c, use_native=True),
                        build_tight_scene(a, b, c, use_native=True), a)
