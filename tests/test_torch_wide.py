"""The plain versions of the port's two kernels against the reference's
Pallas kernels run in interpret mode, on create_n_cubes(120) with 4,096
reference-random and 4,096 aimed rays.

* Group walk (``ops/wide.py``) vs ``trace_closest_hit_tight(interpret=True,
  sweep=False)`` at W=16 and W=32: hit masks equal; shape ids equal outside
  the near-tie class (two triangles whose distances agree within the
  tolerance, ``bvh_tpu/ops/cluster.py:563-571``); raw t within the
  tolerance. The port walks each ray on its own where the TPU kernel walks
  packets, which visits other clusters only in that class.

  The reference's leaf test takes ``pl.reciprocal(approx=True)``, which
  interpret mode evaluates in bfloat16 (up to 2^-8 relative); the port
  takes the IEEE reciprocal. So the reference runs twice: as it ships
  (tolerance 2^-8 + 2·W·2^-23), and with the reciprocal made exact for the
  duration of the test (tolerance 2·W·2^-23, the key truncation). Where
  the exact reference's t lies beyond that tolerance of a float64 oracle's
  (its leaf test rounds ``o - cc`` at a W=32 cluster frame far from the
  ray; the port tests every host build's leaves in the exact frame), the
  port's t is held to float64's at the same tolerance instead (the count
  of such rays asserted: 56 of the 4,096 aimed hits at W=32, else 0).
* Sweep gate (``ops/sweep.py``) vs ``_sweep_tight(interpret=True)``: gates
  equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bvh_tpu
from bvh_tpu.ops.cluster import build_tight_scene as build_j
from bvh_tpu.ops.trace import _pack_rays_tight, _sweep_tight
from bvh_tpu.ops.trace import trace_closest_hit_tight as trace_j
from bvh_tpu_torch import Ray, ray_intersects_triangle
from bvh_tpu_torch import obs
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import build_tight_scene, trace_closest_hit_tight
from bvh_tpu_torch.ops import sweep as sweep_mod
from bvh_tpu_torch.ops import wide as wide_mod
from bvh_tpu_torch.ops.trace import _dev, _ray_rows
from test_torch_dynamic import _oracle64
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
N_CUBES = 120


@pytest.fixture(scope="module")
def cubes():
    return tb.create_n_cubes(N_CUBES)


def _ray_sets(a):
    o, d = tb.create_rays(4096, seed=tb.seed_state_after(N_CUBES))
    ao, ad = tb.aimed_rays(a, 4096)
    return {"random": (o, d), "aimed": (ao, ad)}


# PARITY.md's grazing-edge class: a hit within rounding of a shared edge
# may resolve to the adjacent triangle, t within ~0.3%
GRAZING_RTOL = 3e-3
# rays where the exact reference's t lies beyond the key truncation of
# float64's, by (W, leg), measured: 56 of the 4,096 aimed hits at W=32
N_FAR_REFERENCE = {(32, "aimed"): 56}


def assert_matches_reference(t_j, sid_j, t_t, sid_t, tol, t64=None,
                             n_far=0):
    """Hit masks equal; where the shape ids agree, raw t within ``tol``;
    ids differ on at most 1% of the hits, and only in the near-tie and
    grazing-edge classes (raw t within ``GRAZING_RTOL``). ``t64``: a
    float64 oracle's t; where the ids agree but the reference's t lies
    beyond ``tol`` of it (the reference rounds ``o - cc`` at a cluster
    frame far from the ray, which the port's exact frame does not), the
    port's t is held to float64's within ``tol`` instead, on ``n_far``
    rays (the count measured on the test's rays)."""
    hit = np.isfinite(t_j)
    assert (np.isfinite(t_t) == hit).all()
    assert ((sid_j >= 0) == hit).all() and ((sid_t >= 0) == hit).all()
    same = hit & (sid_j == sid_t)
    far = np.zeros_like(same)
    if t64 is not None:
        far[same] = np.abs(t_j[same] - t64[same]) > tol * t64[same]
        assert far.sum() == n_far
        np.testing.assert_allclose(t_t[far], t64[far], rtol=tol)
        same &= ~far
    np.testing.assert_allclose(t_t[same], t_j[same], rtol=tol)
    diff = hit & (sid_j != sid_t)
    np.testing.assert_allclose(t_t[diff], t_j[diff], rtol=GRAZING_RTOL + tol)
    assert diff.sum() <= max(8, hit.sum() // 100)


@pytest.fixture
def exact_reciprocal(monkeypatch):
    """The reference's approximate reciprocal made exact for one test (the
    compiled traces are dropped before and after, so the patch takes hold
    and does not leak)."""
    jax.clear_caches()
    monkeypatch.setattr(pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _compare_walk(cubes, W, leg, tol, oracle=False):
    a, b, c = cubes
    o, d = _ray_sets(a)[leg]
    sj = build_j(a, b, c, leaf_size=W)
    st = build_tight_scene(a, b, c, leaf_size=W)
    hj = trace_j(sj, bvh_tpu.Ray.create(o, d), interpret=True, sweep=False)
    before = obs.counted("launch.wide_trace")
    ht = trace_closest_hit_tight(st, Ray.create(o, d, device=CPU),
                                 sweep=False, device=CPU)
    # the CPU runs the plain version
    assert obs.counted("launch.wide_trace") == before
    t64 = _oracle64(o, d, a, b, c)[0] if oracle else None
    assert_matches_reference(np.asarray(hj.t), np.asarray(hj.shape_id),
                             ht.t.numpy(), ht.shape_id.numpy(), tol, t64,
                             N_FAR_REFERENCE.get((W, leg), 0) if oracle else 0)
    if leg == "aimed":
        assert np.isfinite(ht.t.numpy()).mean() > 0.99


@pytest.mark.parametrize("W", [16, 32])
@pytest.mark.parametrize("leg", ["random", "aimed"])
def test_plain_group_walk_matches_reference(cubes, W, leg):
    _compare_walk(cubes, W, leg, tol=2.0 ** -8 + 2 * W * 2.0 ** -23)


@pytest.mark.parametrize("W", [16, 32])
@pytest.mark.parametrize("leg", ["random", "aimed"])
def test_plain_group_walk_matches_exact_reference(cubes, W, leg,
                                                  exact_reciprocal):
    _compare_walk(cubes, W, leg, tol=2 * W * 2.0 ** -23, oracle=True)


def test_plain_group_walk_counts(cubes):
    a, b, c = cubes
    st = build_tight_scene(a, b, c)
    o, d = _ray_sets(a)["aimed"]
    rays = Ray.create(o, d, device=CPU)
    rows = _ray_rows(rays, torch.full((len(o),), np.inf))
    args = (_dev(st.gnodes, CPU), _dev(st.groups, CPU), rows, st.width)
    t0, id0 = wide_mod.wide_trace_plain(*args)
    t1, id1, tests, fires = wide_mod.wide_trace_plain(*args, counts=True)
    assert torch.equal(t0, t1) and torch.equal(id0, id1)
    assert (tests >= 1).all() and (fires >= 1).all()
    assert (fires <= tests * wide_mod.K).all()


def test_wrapper_rejects_bad_inputs(cubes):
    a, b, c = cubes
    st = build_tight_scene(a, b, c)
    gn = _dev(st.gnodes, CPU, wide_mod.group_records)
    grp = _dev(st.groups, CPU)
    rows = torch.zeros(wide_mod.N_ROWS, 300)
    with pytest.raises(ValueError, match="rays"):
        wide_mod.wide_trace(gn, grp, rows[:12], 16, st.gdepth)
    with pytest.raises(ValueError, match="depth"):
        wide_mod.wide_trace(gn, grp, rows, 16, wide_mod.WIDE_DMAX)
    with pytest.raises(ValueError, match="gate"):
        wide_mod.wide_trace(gn, grp, rows, 16, st.gdepth,
                            gate=torch.ones(1, dtype=torch.int32), packet=128)
    with pytest.raises(ValueError, match="float32"):
        wide_mod.wide_trace(gn.double(), grp, rows, 16, st.gdepth)
    with pytest.raises(ValueError, match=r"records must be \[Gn, 128\]"):
        wide_mod.wide_trace(_dev(st.gnodes, CPU), grp, rows, 16, st.gdepth)
    with pytest.raises(ValueError, match="packet"):
        sweep_mod.sweep_gate(_dev(st.smem_nodes, CPU, sweep_mod.node_records),
                             rows, 100)


@pytest.mark.parametrize("bounded", [False, True])
def test_plain_sweep_matches_reference(cubes, bounded):
    a, b, c = cubes
    sets = _ray_sets(a)
    o = np.concatenate([sets["random"][0][:2048], sets["aimed"][0][:2048]])
    d = np.concatenate([sets["random"][1][:2048], sets["aimed"][1][:2048]])
    n, packet = len(o), 256
    t_max = None
    if bounded:
        t_max = np.random.default_rng(4).uniform(0, 100, n).astype(np.float32)
    sj = build_j(a, b, c)
    rays_j = bvh_tpu.Ray.create(o, d)
    _, _, slab, _ = _pack_rays_tight(rays_j, packet, t_max)
    sn = jnp.asarray(sj.smem_nodes)
    fired = _sweep_tight(sn, slab, num_nodes=int(sn.shape[1]), interpret=True,
                         packet=packet)
    gate_j = (np.asarray(fired)[:, 0, 0] > 0).astype(np.int32)

    st = build_tight_scene(a, b, c)
    tm = torch.full((n,), np.inf) if t_max is None else torch.from_numpy(t_max)
    rows = _ray_rows(Ray.create(o, d, device=CPU), tm)
    gate_t = sweep_mod.sweep_gate(
        _dev(st.smem_nodes, CPU, sweep_mod.node_records), rows, packet)
    assert gate_t.dtype == torch.int32
    assert np.array_equal(gate_j, gate_t.numpy())
    assert 0 < gate_j.sum() < len(gate_j)


@pytest.mark.parametrize("W", [16, 32])
def test_group_records_hold_the_table(cubes, W):
    """The kernel's group-major copy of gnodes holds the table's own values:
    child k's box at 6k, its payload at 6K + k, the leaf mask at 7K, zeros
    after; ``wide_table`` gives the table back bit for bit (NaN boxes of
    empty slots included), and ``_dev`` makes and uploads it once a table."""
    st = build_tight_scene(*cubes, leaf_size=W)
    gn = torch.from_numpy(st.gnodes)
    rec = _dev(st.gnodes, CPU, wide_mod.group_records)
    K = wide_mod.K
    assert rec.dtype == torch.float32
    assert rec.shape == (gn.shape[1], wide_mod.REC)
    assert wide_mod.REC * 4 == 512  # one record: four 128-byte lines
    box = gn[:7 * K].view(K, 7, -1)
    for k in range(K):
        for j in range(6):
            assert torch.equal(rec[:, 6 * k + j].view(torch.int32),
                               box[k, j].view(torch.int32))
        assert torch.equal(rec[:, 6 * K + k], box[k, 6])
    assert torch.equal(rec[:, 7 * K], gn[7 * K])
    assert not rec[:, 7 * K + 1:].any()
    assert torch.isnan(gn).any()
    assert torch.equal(wide_mod.wide_table(rec).view(torch.int32),
                       gn.view(torch.int32))
    assert _dev(st.gnodes, CPU, wide_mod.group_records) is rec
    assert _dev(st.gnodes, CPU) is not rec


@pytest.fixture(scope="module")
def deep_chain():
    """create_n_cubes(300) (225 clusters of 16) as a chain 14 groups deep,
    with its triangles."""
    tris = tb.create_n_cubes(300)
    return tb.chain_tables(build_tight_scene(*tris), 14), tris


def test_chain_slots_lie_in_the_chain(deep_chain):
    """Every slot that chain_tables lists for a cluster (the hints the card
    tests draw) lies in the chain's own 14-group table and holds that
    cluster: a slot of the source scene's wider table would send a hinted
    walk past the table's end."""
    st, _ = deep_chain
    K = wide_mod.K
    g, k = st.gslot >> 4, st.gslot & (K - 1)
    assert st.gslot.shape == (15 * 13 + K,)
    assert (g >= 0).all() and (g < st.gnodes.shape[1]).all()
    pay = st.gnodes[7 * k + 6, g]
    assert np.array_equal(pay, -(np.arange(len(pay)) + 1.0))
    lmask = st.gnodes[7 * K, g].astype(np.int64)
    assert ((lmask >> k) & 1).all()


def test_wrappers_refuse_depth_above_14(deep_chain):
    """The deepest wide tree the kernels take is 14 groups (the nearest
    group walk's 64-bit DFS key holds 14 levels, and the scene build makes
    no deeper table); 15 is refused on every device, 14 is taken."""
    st, _ = deep_chain
    assert st.gdepth == wide_mod.MAX_DEPTH == 14
    gn = _dev(st.gnodes, CPU, wide_mod.group_records)
    grp = _dev(st.groups, CPU)
    rows = torch.zeros(wide_mod.N_ROWS, 64)
    for depth in (15, 0):
        with pytest.raises(ValueError, match=rf"depth {depth} outside 1\.\.14"):
            wide_mod.wide_trace(gn, grp, rows, 16, depth)
    t, lane_id = wide_mod.wide_trace(gn, grp, rows, 16, 14)
    assert not (lane_id >= 0).any()


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_deep_chain_table_matches_brute_force(deep_chain, mode):
    """The group walk over a table 14 groups deep (testbase.chain_tables,
    which keeps 211 of the scene's clusters): the closest hit equals brute
    force over the triangles the chain holds, and any hit finds a hit
    exactly where it does."""
    st, (a, b, c) = deep_chain
    o, d = tb.aimed_rays(a, 2048, seed=3)
    rays = Ray.create(o, d, device=CPU)
    rows = _ray_rows(rays, torch.full((len(o),), np.inf))
    t, lane_id = wide_mod.wide_trace(
        _dev(st.gnodes, CPU, wide_mod.group_records), _dev(st.groups, CPU),
        rows, 16, 14, mode=mode)
    # the triangles of the chain's clusters (clusters 0..210, W = 16)
    lanes = np.concatenate([np.arange(16) + (c_ // 8) * 128 + (c_ % 8) * 16
                            for c_ in range(15 * 13 + 16)])
    ids = st.tri_map[lanes]
    ids = ids[ids >= 0]
    tt = tuple(torch.from_numpy(x[ids])[None] for x in (a, b, c))
    brute = ray_intersects_triangle(Ray(*(x[:, None] for x in rays)), *tt)
    bt = brute.distance.amin(dim=1)
    hit = lane_id >= 0
    assert torch.equal(hit, torch.isfinite(bt))
    assert 0 < int(hit.sum()) < len(o)
    if mode == "closest":
        rel = (t[hit] - bt[hit]).abs() / bt[hit]
        assert float(rel.max()) <= 2 * 16 * 2.0 ** -23 + 1e-6


def test_layout_constants_match_reference():
    """The public layout constants: clusters a group row
    (``ops/cluster.py::GROUP``), the default packet
    (``ops/trace.py::PACKET``) and the group walk's stack depth
    (``ops/trace.py::WIDE_DMAX``), the reference's values."""
    from bvh_tpu.ops import cluster as cluster_j
    from bvh_tpu.ops import trace as trace_j_mod
    from bvh_tpu_torch.ops import cluster as cluster_t
    from bvh_tpu_torch.ops import trace as trace_t

    assert (cluster_t.GROUP, trace_t.PACKET, trace_t.WIDE_DMAX) == (
        cluster_j.GROUP, trace_j_mod.PACKET, trace_j_mod.WIDE_DMAX)
    assert trace_t.WIDE_DMAX == wide_mod.WIDE_DMAX
