"""The port's nearest-triangle path against the reference on small scenes.

* ``bvh_tpu_torch.tri`` against ``bvh_tpu.tri`` on points in all seven
  regions of a triangle (rtol 1e-6, atol 1e-6: both are float32 with the
  same formula).
* The plain narrowphase against the reference's oracle on random triangles,
  with a winner in each of the seven regions.
* ``sort_points_device``: the same permutation as the reference's.
* ``nearest_tight`` in both walks against the reference's
  ``nearest_tight(interpret=True)`` on create_n_cubes(120) at W=16, with
  ``d_max`` None, scalar and per point, sort on and off: masks equal,
  distances within rtol 1e-5, atol 1e-5, shape ids equal except where the
  two winners' brute-force distances agree within 1e-5 relative (the tie
  and key-truncation class). The port walks each point on its own where the
  TPU kernels walk packets, which changes the visited set only in that
  class.
* Wide leaves on a sparse scene (create_n_cubes(90), W=64 and 128): within
  1e-2 of brute force, the reference's own bound.
* The port's group walk equals its entry/exit walk bit for bit.
* A masked part from the reference's ``make_updater``, carried with
  ``scene_from_arrays``, against the reference on the same part and brute
  force.
* The exact cluster frame (``a_lo``, the kernels' FRAME builds) on device
  builds of create_n_cubes(40), whose frame origins lie up to ~1e5 from
  their triangles: the two plain walks equal bit for bit with and without
  counts, the wrappers pass ``a_lo`` to them, and ``nearest_chained`` over
  a device chain takes each part's own frame: every reported triangle's
  float64 squared distance is the least over all triangles in float64
  within the near-tie class (2^-20 relative).
* The bound seed (``nearest_seed``) on the cubes120 points with ``d_max``
  None, scalar and per point, and on the far-frame device build: its bound
  at least float64 brute force's nearest d², the row min(d_max², seed);
  both walks from the seeded rows give the unseeded walks' d2 bit for bit
  and their lanes outside the tie class; the wrapper runs the plain seed
  on CPU tensors; ``nearest_tight`` seeds exactly the scenes with
  ``gnodes`` that are not masked; on uniform points over
  create_n_cubes(120) no point fires more leaves seeded, and the mean
  falls at least 5x.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu import tri as tri_j
from bvh_tpu.ops.cluster import build_tight_scene as build_j
from bvh_tpu.ops.nearest import nearest_tight as nearest_j
from bvh_tpu.ops.nearest import sort_points_device as sort_points_j
from bvh_tpu_torch import obs
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch import tri
from bvh_tpu_torch.ops import (build_chained_scene_device, build_tight_scene,
                               build_tight_scene_device, make_updater,
                               nearest_chained, nearest_tight,
                               scene_from_arrays, sort_points_device)
from bvh_tpu_torch.ops import nearest as near_mod
from bvh_tpu_torch.ops.trace import _dev
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def brute_d2(pts, a, b, c):
    """[n, m] squared distances by the reference's oracle."""
    return np.asarray(tri_j.point_triangle_distance_squared(
        jnp.asarray(pts)[:, None, :], jnp.asarray(a)[None],
        jnp.asarray(b)[None], jnp.asarray(c)[None]))


def winner_d(pts, sid, a, b, c):
    """Brute-force distance from each point to triangle ``sid``."""
    s = np.maximum(sid, 0)
    return np.sqrt(np.asarray(tri_j.point_triangle_distance_squared(
        jnp.asarray(pts), jnp.asarray(a[s]), jnp.asarray(b[s]),
        jnp.asarray(c[s]))))


def near_points(a, b, c, n, scale, seed):
    rng = np.random.default_rng(seed)
    cen = (a + b + c) / 3.0
    return (cen[rng.integers(0, len(cen), n)]
            + rng.normal(scale=scale, size=(n, 3))).astype(np.float32)


# ---- tri.py ---------------------------------------------------------------

def _tri_inputs():
    a = np.array([0.0, 0.0, 0.0], np.float32)
    b = np.array([4.0, 0.0, 0.0], np.float32)
    c = np.array([0.0, 3.0, 0.0], np.float32)
    # one point in each region: A, B, C, AB, AC, BC, face
    fixed = np.array([[-1, -1, 0.5], [5, -1, -0.3], [-1, 4, 1], [2, -2, 0.7],
                      [-2, 1.5, 0.2], [3, 2, 0.4], [1, 1, 2]], np.float32)
    rng = np.random.default_rng(5)
    ta, tb_, tc = (rng.normal(size=(48, 3)).astype(np.float32) * 3
                   for _ in range(3))
    p = rng.normal(size=(64, 1, 3)).astype(np.float32) * 6
    return [(fixed, a, b, c), (p, ta[None], tb_[None], tc[None])]


def _region(p, a, b, c):
    """Ericson's region of ``p`` (float64, priority order)."""
    ab, ac = b - a, c - a
    d1, d2 = ab @ (p - a), ac @ (p - a)
    d3, d4 = ab @ (p - b), ac @ (p - b)
    d5, d6 = ab @ (p - c), ac @ (p - c)
    vc, vb, va = d1 * d4 - d3 * d2, d5 * d2 - d1 * d6, d3 * d6 - d5 * d4
    for name, cond in (("A", d1 <= 0 and d2 <= 0), ("B", d3 >= 0 and d4 <= d3),
                       ("AB", vc <= 0 and d1 >= 0 and d3 <= 0),
                       ("C", d6 >= 0 and d5 <= d6),
                       ("AC", vb <= 0 and d2 >= 0 and d6 <= 0),
                       ("BC", va <= 0 and d4 - d3 >= 0 and d5 - d6 >= 0)):
        if cond:
            return name
    return "face"


@pytest.mark.parametrize("fn", ["closest_point_on_triangle",
                                "point_triangle_distance_squared"])
def test_tri_matches_reference(fn):
    p, a, b, c = (x.astype(np.float64) for x in _tri_inputs()[0])
    assert [_region(q, a, b, c) for q in p] == ["A", "B", "C", "AB", "AC",
                                                "BC", "face"]
    for p, a, b, c in _tri_inputs():
        want = np.asarray(getattr(tri_j, fn)(*(jnp.asarray(x)
                                               for x in (p, a, b, c))))
        got = getattr(tri, fn)(*(torch.from_numpy(x) for x in (p, a, b, c)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_narrowphase_matches_brute_force():
    """The plain narrowphase on clusters of random triangles in a ±4 frame
    against the reference's oracle: on one-triangle clusters every region's
    formula decides the distance; on full clusters the smallest key picks
    the nearest lane."""
    W, G = 16, 2
    rng = np.random.default_rng(12)
    a = rng.normal(size=(G * 128, 3)).astype(np.float32) * 4
    e1 = rng.normal(size=(G * 128, 3)).astype(np.float32) * 2
    e2 = rng.normal(size=(G * 128, 3)).astype(np.float32) * 2
    single = np.arange(G * 128) // W % 2 == 0  # even clusters: lane 0 only
    single &= np.arange(G * 128) % W != 0
    for x in (a, e1, e2):
        x[single] = 0.0
    rows = np.zeros((G * 128, 16), np.float32)
    rows[:, 0:3], rows[:, 3:6], rows[:, 6:9] = a, e1, e2
    tiles = torch.from_numpy(rows.reshape(G, 128, 16)[:, :, :9].copy())
    n = 4096
    p = rng.normal(size=(n, 3)).astype(np.float32) * 6
    c = rng.integers(0, G * 128 // W, n)
    zero = torch.zeros(n)
    km = near_mod._narrow_plain(near_mod.point_rows(torch.from_numpy(p), None),
                                tiles, W, torch.arange(n), torch.from_numpy(c),
                                zero, zero, zero)
    d2 = (km & -W).view(torch.float32).numpy()
    lane = (km & (W - 1)).numpy()
    tri_id = c[:, None] * W + np.arange(W)[None, :]
    bd2 = np.asarray(tri_j.point_triangle_distance_squared(
        jnp.asarray(p)[:, None, :], jnp.asarray(a[tri_id]),
        jnp.asarray((a + e1)[tri_id]), jnp.asarray((a + e2)[tri_id])))
    live = ~single[tri_id]
    bd2 = np.where(live, bd2, np.inf)
    best = bd2.min(axis=1)
    # d2 is truncated by up to W-1 ulps; the two formulas round apart
    np.testing.assert_allclose(d2, best, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(bd2[np.arange(n), lane], best, rtol=2e-5,
                               atol=1e-5)
    regions = {_region(q.astype(np.float64), a[t].astype(np.float64),
                       (a + e1)[t].astype(np.float64),
                       (a + e2)[t].astype(np.float64))
               for q, t in zip(p, tri_id[np.arange(n), lane])}
    assert regions == {"A", "B", "C", "AB", "AC", "BC", "face"}


# ---- sort ---------------------------------------------------------------

def test_sort_points_matches_reference():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1e5, 1e5, (3000, 3)).astype(np.float32)
    pts[1000:1100] = pts[0]  # ties keep their input order
    perm_j, inv_j = sort_points_j(pts)
    perm, inv = sort_points_device(pts, device=CPU)
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_j))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(inv_j))
    e, _ = sort_points_device(np.zeros((0, 3), np.float32), device=CPU)
    assert e.shape == (0,)


# ---- nearest_tight against the reference -----------------------------------

@pytest.fixture(scope="module")
def cubes120():
    a, b, c = tb.create_n_cubes(120)
    rng = np.random.default_rng(31)
    pts = np.concatenate([
        near_points(a, b, c, 192, 20.0, 7),
        rng.uniform(-1.2e5, 1.2e5, (64, 3)).astype(np.float32)])
    bd = np.sqrt(brute_d2(pts, a, b, c).min(axis=1))
    d_max = {None: None, "scalar": np.float32(25.0),
             "per_point": (np.random.default_rng(8).uniform(0, 2, len(pts))
                           * bd).astype(np.float32)}
    return ((a, b, c), build_j(a, b, c), build_tight_scene(a, b, c), pts,
            d_max)


def assert_matches(sid_j, d_j, sid_t, d_t, pts, tris):
    hit = sid_j >= 0
    np.testing.assert_array_equal(sid_t >= 0, hit)
    np.testing.assert_array_equal(np.isposinf(d_t), ~hit)
    np.testing.assert_allclose(d_t[hit], d_j[hit], rtol=1e-5, atol=1e-5)
    diff = hit & (sid_t != sid_j)
    if diff.any():
        wj = winner_d(pts[diff], sid_j[diff], *tris)
        wt = winner_d(pts[diff], sid_t[diff], *tris)
        np.testing.assert_allclose(wt, wj, rtol=1e-5, atol=0)


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("dm", [None, "scalar", "per_point"])
@pytest.mark.parametrize("wide", [None, False])
def test_nearest_matches_reference(cubes120, wide, dm, sort):
    tris, sj, st, pts, d_max = cubes120
    sid_j, d_j = nearest_j(sj, pts, packet=256, d_max=d_max[dm],
                           interpret=True, wide=wide, sort=sort)
    walks = ("launch.nearest_wide", "launch.nearest_entry_exit")
    before = [obs.counted(k) for k in walks]
    sid_t, d_t = nearest_tight(st, pts, d_max=d_max[dm], wide=wide,
                               sort=sort, device=CPU)
    # the CPU runs the plain versions
    assert [obs.counted(k) for k in walks] == before
    assert sid_t.dtype == torch.int32 and d_t.dtype == torch.float32
    assert_matches(np.asarray(sid_j), np.asarray(d_j), sid_t.numpy(),
                   d_t.numpy(), pts, tris)
    hit = sid_t.numpy() >= 0
    if dm is None:
        assert hit.all()
    else:
        assert 0 < hit.sum() < len(pts)


@pytest.mark.parametrize("wide", [None, False])
@pytest.mark.parametrize("W", [64, 128])
def test_nearest_sparse_wide_leaves(W, wide):
    a, b, c = tb.create_n_cubes(90)
    pts = near_points(a, b, c, 384, 25.0, 1)
    bd = np.sqrt(brute_d2(pts, a, b, c).min(axis=1))
    st = build_tight_scene(a, b, c, leaf_size=W)
    _, dist = nearest_tight(st, pts, wide=wide, device=CPU)
    assert np.abs(dist.numpy() - bd).max() < 1e-2


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("dm", [None, 40.0])
def test_wide_walk_equals_entry_exit(cubes120, dm, refine):
    _, _, st, pts, _ = cubes120
    t = torch.from_numpy(pts)
    rows = near_mod.point_rows(t, None if dm is None
                               else torch.full((len(pts),), dm))
    grp = _dev(st.groups, CPU)
    dw, iw, tests, wfires = near_mod.nearest_wide_plain(
        _dev(st.gnodes, CPU), grp, rows, st.width, refine=refine, counts=True)
    de, ie, visits, efires = near_mod.nearest_entry_exit_plain(
        _dev(st.smem_nodes, CPU), grp, rows, st.width, refine=refine,
        counts=True)
    assert torch.equal(dw.view(torch.int32), de.view(torch.int32))
    assert torch.equal(iw, ie)
    assert (iw >= 0).any()
    # the counts do not change the results
    d0, i0 = near_mod.nearest_wide(_dev(st.gnodes, CPU), grp, rows, st.width,
                                   st.gdepth, refine=refine)
    assert torch.equal(d0.view(torch.int32), dw.view(torch.int32))
    assert torch.equal(i0, iw)
    assert (tests >= 1).all() and (visits >= 1).all()
    assert (wfires <= tests * near_mod.K).all() and (efires <= visits).all()
    assert (tests <= visits).all()  # a group test covers 16 children
    if dm is None:
        assert (wfires >= 1).all() and (efires >= 1).all()


def test_masked_updater_part():
    """The static part of the reference's ``make_updater`` after a whole
    cluster was vacated: its stale box must not refine the bound."""
    from bvh_tpu.ops import make_updater

    a, b, c = tb.create_n_cubes(50)
    sj = build_j(a, b, c)
    tri_map = np.asarray(sj.tri_map)
    moved = tri_map[:sj.width]
    moved = moved[moved >= 0].astype(np.int32)  # cluster 0's triangles
    a2, b2, c2 = a.copy(), b.copy(), c.copy()
    for arr in (a2, b2, c2):
        arr[moved] += np.float32(1e6)
    upd = make_updater(sj, max_moved=len(moved))
    part = upd(jnp.asarray(a2), jnp.asarray(b2), jnp.asarray(c2),
               jnp.asarray(moved)).parts[0]
    st = scene_from_arrays(part._asdict())
    assert st.masked
    col = int(np.nonzero(np.asarray(sj.smem_nodes[6]) == -1.0)[0][0])
    centre = (np.asarray(sj.smem_nodes[0:3, col])
              + np.asarray(sj.smem_nodes[3:6, col])) * 0.5
    pts = (centre + np.random.default_rng(3).normal(scale=30.0, size=(256, 3))
           ).astype(np.float32)
    keep = np.setdiff1d(np.arange(len(a)), moved)
    bd = np.sqrt(brute_d2(pts, a[keep], b[keep], c[keep]).min(axis=1))
    for wide in (None, False):
        sid_j, d_j = nearest_j(part, pts, packet=256, interpret=True,
                               wide=wide)
        sid_t, d_t = nearest_tight(st, pts, wide=wide, device=CPU)
        assert_matches(np.asarray(sid_j), np.asarray(d_j), sid_t.numpy(),
                       d_t.numpy(), pts, (a, b, c))
        np.testing.assert_allclose(d_t.numpy(), bd, rtol=1e-5, atol=1e-4)
        assert not np.isin(sid_t.numpy(), moved).any()


def test_nearest_empty_and_one_point():
    a, b, c = tb.create_n_cubes(3)
    st = build_tight_scene(a, b, c)
    sid, dist = nearest_tight(st, np.zeros((0, 3), np.float32), device=CPU)
    assert sid.shape == (0,) and dist.shape == (0,)
    assert sid.dtype == torch.int32 and dist.dtype == torch.float32
    pts = np.array([[5.0, -3.0, 40.0]], np.float32)
    sid, dist = nearest_tight(st, pts, device=CPU)
    bd2 = brute_d2(pts, a, b, c)
    assert int(sid[0]) == int(bd2.argmin())
    np.testing.assert_allclose(dist.numpy(), np.sqrt(bd2.min(axis=1)),
                               rtol=1e-5)


def test_nearest_rejects_bad_inputs(cubes120):
    _, _, st, pts, _ = cubes120
    gn, grp = _dev(st.gnodes, CPU), _dev(st.groups, CPU)
    sn = _dev(st.smem_nodes, CPU)
    rows = near_mod.point_rows(torch.from_numpy(pts), None)
    with pytest.raises(ValueError, match="pts"):
        near_mod.nearest_wide(gn, grp, rows[:3], st.width, st.gdepth)
    with pytest.raises(ValueError, match="depth"):
        near_mod.nearest_wide(gn, grp, rows, st.width, near_mod.WIDE_DMAX)
    with pytest.raises(ValueError, match="float32"):
        near_mod.nearest_entry_exit(sn.double(), grp, rows, st.width)
    with pytest.raises(ValueError, match="smem_nodes"):
        near_mod.nearest_entry_exit(gn, grp, rows, st.width)
    with pytest.raises(ValueError, match="width"):
        near_mod.nearest_entry_exit(sn, grp, rows, 8)
    with pytest.raises(ValueError, match="packet"):
        nearest_tight(st, pts, packet=100, device=CPU)
    with pytest.raises(ValueError, match="wide"):
        nearest_tight(st._replace(gnodes=None), pts, wide=True, device=CPU)
    with pytest.raises(ValueError, match="packed"):
        nearest_tight(st._replace(packed_nodes=np.zeros((5, 8), np.float32)),
                      pts, device=CPU)


def test_nearest_never_falls_back_to_cpu(cubes120):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    _, _, st, pts, _ = cubes120
    with pytest.raises(RuntimeError, match="CUDA"):
        nearest_tight(st, pts)
    with pytest.raises(RuntimeError, match="CUDA"):
        sort_points_device(pts)


@pytest.mark.parametrize("refine", [True, False])
def test_deep_chain_table(refine):
    """Both nearest walks over a tree 14 groups deep (testbase.chain_tables
    over create_n_cubes(300)): bit-equal to each other, each point's d²
    within the key truncation of brute force over the chain's triangles;
    the group walk takes depth 14 and refuses 15."""
    a, b, c = tb.create_n_cubes(300)
    st = tb.chain_tables(build_tight_scene(a, b, c), 14)
    lanes = np.concatenate([np.arange(16) + (c_ // 8) * 128 + (c_ % 8) * 16
                            for c_ in range(15 * 13 + 16)])
    ids = st.tri_map[lanes]
    ids = ids[ids >= 0]
    pts = near_points(a[ids], b[ids], c[ids], 512, 15.0, 4)
    rows = near_mod.point_rows(torch.from_numpy(pts), None)
    gn, sn, grp = (_dev(x, CPU) for x in (st.gnodes, st.smem_nodes, st.groups))
    dw, iw = near_mod.nearest_wide(gn, grp, rows, 16, 14, refine=refine)
    de, ie = near_mod.nearest_entry_exit(sn, grp, rows, 16, refine=refine)
    assert torch.equal(dw.view(torch.int32), de.view(torch.int32))
    assert torch.equal(iw, ie)
    bd2 = brute_d2(pts, a[ids], b[ids], c[ids]).min(axis=1)
    np.testing.assert_allclose(dw.numpy(), bd2, rtol=2 * 16 * 2.0 ** -23 + 1e-6)
    with pytest.raises(ValueError, match=r"depth 15 outside 1\.\.14"):
        near_mod.nearest_wide(gn, grp, rows, 16, 15)


# ---- the exact cluster frame (a_lo) of device-built scenes -----------------

NEAR_TIE_RTOL = 2.0 ** -20


def _far_points(a, n_per: int = 13, seed: int = 23):
    """Points within a few units of each cube's centre (its triangles' frame
    origins lie up to ~1e5 away in a device build)."""
    rng = np.random.default_rng(seed)
    centers = a.reshape(-1, 12, 3).mean(axis=1)
    return (np.repeat(centers, n_per, axis=0)
            + rng.normal(scale=1.5, size=(len(centers) * n_per, 3))
            ).astype(np.float32)


def _brute64(pts, a, b, c):
    """[n, m] squared distances in float64."""
    return tri.point_triangle_distance_squared(
        torch.from_numpy(pts).double()[:, None],
        *(torch.from_numpy(x).double()[None] for x in (a, b, c))).numpy()


@pytest.mark.parametrize("refine", [True, False])
def test_frame_walks_agree(refine):
    """On a device build, the plain group and entry/exit walks with
    ``a_lo`` equal bit for bit, with and without counts; the wrappers on
    CPU tensors run them with the frame; the frame changes the result
    (the rounded frame's point 326)."""
    a, b, c = tb.create_n_cubes(40)
    st = build_tight_scene_device(a, b, c, device=CPU)
    rows = near_mod.point_rows(torch.from_numpy(_far_points(a)), None)
    gn, sn, grp, alo = st.gnodes, st.smem_nodes, st.groups, st.a_lo
    dw, iw, _, wf = near_mod.nearest_wide_plain(
        gn, grp, rows, st.width, refine=refine, counts=True, a_lo=alo)
    de, ie, _, ef = near_mod.nearest_entry_exit_plain(
        sn, grp, rows, st.width, refine=refine, counts=True, a_lo=alo)
    assert torch.equal(dw.view(torch.int32), de.view(torch.int32))
    assert (iw >= 0).all() and (ie >= 0).all()
    # the exact frame makes the two triangles of a cube face equally near
    # a point by their shared edge: the walks, which order their leaves
    # differently, may then keep either (the near-tie class)
    tm = np.asarray(st.tri_map)
    pts = rows[:3].T.contiguous().numpy()
    d2 = _brute64(pts, a, b, c)
    k = np.arange(len(pts))
    for lane in (iw.numpy(), ie.numpy()):
        assert (d2[k, tm[lane]] <= d2.min(axis=1) * (1 + NEAR_TIE_RTOL)).all()
    assert (iw != ie).sum() <= len(pts) // 10
    assert (wf >= 1).all() and (ef >= 1).all()
    for fn, table, extra, plain in (
            (near_mod.nearest_wide, gn, (st.gdepth,), iw),
            (near_mod.nearest_entry_exit, sn, (), ie)):
        d0, i0 = fn(table, grp, rows, st.width, *extra, refine=refine,
                    a_lo=alo)
        assert torch.equal(d0.view(torch.int32), dw.view(torch.int32))
        assert torch.equal(i0, plain)
    _, i1 = near_mod.nearest_wide_plain(gn, grp, rows, st.width,
                                        refine=refine)
    assert int(tm[i1[326]]) == 302 and int(tm[iw[326]]) == 307
    with pytest.raises(ValueError, match="a_lo"):
        near_mod.nearest_wide(gn, grp, rows, st.width, st.gdepth,
                              a_lo=alo[:, :2].contiguous())
    with pytest.raises(ValueError, match="a_lo"):
        near_mod.nearest_entry_exit(sn, grp, rows, st.width,
                                    a_lo=alo.double())


def test_nearest_chained_takes_each_parts_frame(monkeypatch):
    """A device chain of create_n_cubes(40) in parts of 160 triangles: each
    part's walk gets that part's own ``a_lo``, and every reported
    triangle is float64 brute force's nearest within the near-tie class,
    with and without a radius."""
    a, b, c = tb.create_n_cubes(40)
    ch = build_chained_scene_device(a, b, c, max_part=160, device=CPU)
    assert len(ch.parts) > 1 and all(p.a_lo is not None for p in ch.parts)
    pts = _far_points(a)
    seen = []
    walk = near_mod.nearest_wide

    def spy(*args, **kw):
        seen.append(kw["a_lo"])
        return walk(*args, **kw)

    monkeypatch.setattr(near_mod, "nearest_wide", spy)
    sid, dist = nearest_chained(ch, pts, device=CPU)
    assert len(seen) == len(ch.parts)
    assert all(x is p.a_lo for x, p in zip(seen, ch.parts))
    d2 = _brute64(pts, a, b, c)
    best = d2.min(axis=1)
    sid = sid.numpy()
    assert (sid >= 0).all()
    assert (d2[np.arange(len(pts)), sid] <= best * (1 + NEAR_TIE_RTOL)).all()
    bd = np.sqrt(best)
    np.testing.assert_allclose(dist.numpy(), bd, rtol=1e-5, atol=1e-2)
    sid_r, _ = nearest_chained(ch, pts, d_max=1.0, device=CPU)
    inside = bd < 1.0 - 1e-3
    assert (sid_r.numpy()[inside] >= 0).all()
    assert (sid_r.numpy()[bd > 1.0 + 1e-3] == -1).all()


# ---- the bound seed ---------------------------------------------------------

def _seed_cases(cubes120):
    """(name, triangles, scene, points, radius, frame) for the seed's tests:
    the cubes120 scene's points with d_max None, scalar and per point, and
    a device build of create_n_cubes(40) with ``_far_points`` and its
    ``a_lo``."""
    tris, _, st, pts, d_max = cubes120
    out = [(f"cubes120/{dm}", tris, st, pts,
            None if r is None else torch.as_tensor(r).expand(len(pts)), None)
           for dm, r in d_max.items()]
    far = tb.create_n_cubes(40)
    dev_st = build_tight_scene_device(*far, device=CPU)
    out.append(("far", far, dev_st, _far_points(far[0]), None, dev_st.a_lo))
    return out


def test_seed_bounds_brute_force(cubes120):
    """The seed is at least float64 brute force's nearest d² of every
    point; with a radius the row is min(d_max², seed)."""
    for name, tris, st, pts, dm, _ in _seed_cases(cubes120):
        gn = _dev(st.gnodes, CPU)
        t = torch.from_numpy(pts)
        rows = near_mod.point_rows(t, None)
        tests = near_mod.nearest_seed_plain(gn, rows, counts=True)
        best = _brute64(pts, *tris).min(axis=1)
        assert (rows[3].double().numpy() >= best).all(), name
        assert np.isfinite(rows[3].numpy()).all(), name
        assert ((tests >= 1) & (tests <= st.gdepth)).all(), name
        if dm is not None:
            rb = near_mod.point_rows(t, dm)
            want = torch.minimum(rb[3], rows[3])
            assert near_mod.nearest_seed_plain(gn, rb) is None
            assert torch.equal(rb[3], want), name


@pytest.mark.parametrize("wide", [True, False])
def test_seeded_walks_equal_unseeded(cubes120, wide):
    """Both walks from the seeded rows: d2 bit-equal to the same walk
    unseeded; a lane differs only where the two triangles lie equally near
    (the tie class of ``assert_matches``, the near-tie class on far
    frames)."""
    for name, tris, st, pts, dm, a_lo in _seed_cases(cubes120):
        rows = near_mod.point_rows(torch.from_numpy(pts), dm)
        seeded = rows.clone()
        near_mod.nearest_seed_plain(_dev(st.gnodes, CPU), seeded)
        assert (seeded[3] <= rows[3]).all() and (seeded[3] < rows[3]).any()
        grp = _dev(st.groups, CPU)
        if wide:
            walk = functools.partial(near_mod.nearest_wide_plain,
                                     _dev(st.gnodes, CPU))
        else:
            walk = functools.partial(near_mod.nearest_entry_exit_plain,
                                     _dev(st.smem_nodes, CPU))
        d0, i0 = walk(grp, rows, st.width, a_lo=a_lo)
        d1, i1 = walk(grp, seeded, st.width, a_lo=a_lo)
        assert torch.equal(d0.view(torch.int32), d1.view(torch.int32)), name
        assert (i0 >= 0).any(), name
        diff = (i0 != i1).numpy()
        if diff.any():
            tm = np.asarray(st.tri_map)
            s0, s1 = tm[i0.numpy()[diff]], tm[i1.numpy()[diff]]
            w0 = winner_d(pts[diff], s0, *tris)
            w1 = winner_d(pts[diff], s1, *tris)
            np.testing.assert_allclose(w1, w0, rtol=1e-5, atol=0)


def test_seed_wrapper_runs_plain_on_cpu(cubes120):
    _, _, st, pts, _ = cubes120
    gn = _dev(st.gnodes, CPU)
    rows = near_mod.point_rows(torch.from_numpy(pts), None)
    want = rows.clone()
    tests = near_mod.nearest_seed_plain(gn, want, counts=True)
    before = [obs.counted(k) for k in ("launch.nearest_seed",
                                       "launch.nearest_seed_count")]
    got = rows.clone()
    assert near_mod.nearest_seed(gn, got) is None
    assert torch.equal(got, want)
    got = rows.clone()
    assert torch.equal(near_mod.nearest_seed(gn, got, counts=True), tests)
    assert torch.equal(got, want)
    assert [obs.counted(k) for k in ("launch.nearest_seed",
                                     "launch.nearest_seed_count")] == before
    with pytest.raises(ValueError, match="gnodes"):
        near_mod.nearest_seed(_dev(st.smem_nodes, CPU), rows)
    with pytest.raises(ValueError, match="pts"):
        near_mod.nearest_seed(gn, rows[:3].contiguous())
    with pytest.raises(ValueError, match="float32"):
        near_mod.nearest_seed(gn, rows.double())


def test_seed_only_where_the_scene_allows(cubes120, monkeypatch):
    """``nearest_tight`` seeds a scene with ``gnodes`` that is not masked, in
    both walks; a masked part (an updater's static part) or a scene
    without ``gnodes`` takes no seed and counts ``nearest.unseeded``."""
    tris, _, st, pts, _ = cubes120
    calls = []
    seed = near_mod.nearest_seed

    def spy(gn, rows, counts=False):
        calls.append(rows.shape[1])
        return seed(gn, rows, counts=counts)

    monkeypatch.setattr(near_mod, "nearest_seed", spy)
    masked = make_updater(st, max_moved=16, device=CPU)(
        *tris, np.arange(16, dtype=np.int32)).parts[0]
    assert masked.masked and masked.gnodes is not None
    for scene, wide, seeds in ((st, None, True), (st, False, True),
                               (masked, None, False),
                               (st._replace(gnodes=None), None, False)):
        calls.clear()
        before = obs.counted("nearest.unseeded")
        nearest_tight(scene, pts, wide=wide, device=CPU)
        assert calls == ([len(pts)] if seeds else [])
        assert obs.counted("nearest.unseeded") == before + (not seeds)


def test_seed_cuts_the_fires_on_uniform_points():
    """On create_n_cubes(120) with points uniform in the scene's range, no
    point fires more leaves from the seeded rows than unseeded, and the
    mean falls at least 5x."""
    a, b, c = tb.create_n_cubes(120)
    st = build_tight_scene(a, b, c)
    pts = torch.from_numpy(np.random.default_rng(9).uniform(
        -1e5, 1e5, (1024, 3)).astype(np.float32))
    rows = near_mod.point_rows(pts, None)
    seeded = rows.clone()
    near_mod.nearest_seed_plain(_dev(st.gnodes, CPU), seeded)
    gn, grp = _dev(st.gnodes, CPU), _dev(st.groups, CPU)
    *_, f0 = near_mod.nearest_wide_plain(gn, grp, rows, st.width,
                                         counts=True)
    *_, f1 = near_mod.nearest_wide_plain(gn, grp, seeded, st.width,
                                         counts=True)
    assert (f1 <= f0).all()
    assert f0.double().mean() >= 5 * f1.double().mean()
