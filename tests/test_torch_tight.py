"""The port's entry/exit walk, packed/bmat/sweep_cut scene builds, any-hit
traces, hints and pre-gates against bvh_tpu (Pallas in interpret mode), on
create_n_cubes(40) with reference-random, aimed and near rays.

Tolerances:

* Scene builds: every TightScene field array-equal (``equal_nan`` for the
  NaN-padded wide table); the port's ``a_lo`` equal to the float64
  remainder (``test_torch_scene.exact_a_lo``; on packed scenes against the
  raw packed-row frame origin).
* Entry/exit walk vs the reference's ``trace_closest_hit_tight(wide=False)``
  with its reciprocal made exact (``exact_reciprocal``): hit masks equal; t
  bits equal wherever the shape ids agree, except on at most 1% of the hits
  where the two packages' t·det forms (the reference sums them from
  m = o×d) round t across one key step, W ulps, and except where the
  reference's t lies more than a key step from a float64 oracle's (its
  rounded ``o - cc`` at a W=32 cluster frame far from the ray; the port
  tests every host build's leaves in the exact frame), where the port's t
  is held to float64's within one key step instead (the count of such rays
  asserted: 19 of 513 hits at W=32, 18 of 512 on the bmat scene, 0 at
  W=16); ids differ on at most
  1% of the hits, and only where the two raw distances agree within
  ``GRAZING_RTOL`` (the near-tie and grazing-edge classes, PARITY.md: the
  reference's forms may take a ray across a shared edge into the adjacent
  triangle). The port's two walks agree with each other bit for bit.
* Packed scenes: the reference's packed test's tolerances
  (tests/test_tight_kernel.py:309-345).
* bmat scenes: t within rtol 1e-5 with equal ids (the reference's own bmat
  test, tests/test_tight_kernel.py:259-283); the port evaluates the leaf
  test from ``groups`` on bmat scenes, so it equals the default scene's
  trace bit for bit.
* Any hit: equal to the port's closest hit below t_max except on rays whose
  nearest hit lies within ``GRAZING_RTOL`` of t_max, and to the reference's
  ``trace_any_hit_tight`` except where it lies within ``GRAZING_RTOL`` plus
  the reference's approximate reciprocal (2^-8) of t_max.
* Hints and pre-gates change no result bit outside the gated packets.
* ``skip_narrow`` (the broadphase-only walk): every ray misses (t = +inf,
  shape id -1, u = v = 0) in the port and in the reference's
  ``trace_closest_hit_tight(skip_narrow=True)``; the reference's rules
  (``wide=True`` raises, no sweep, hints not read, pre-gates kept); on
  packets of one repeated ray the port's visit sums are exactly packet x
  the reference's ``_trace_tight(skip_narrow=True, count_visits=True)``
  count, and both count no fire.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bvh_tpu
from bvh_tpu.ops import cluster as cluster_j
from bvh_tpu.ops.cluster import build_tight_scene as build_j
from bvh_tpu.ops.trace import (_pack_rays_tight, _sweep_tight, _trace_tight,
                               compute_seed_hints)
from bvh_tpu.ops.trace import make_tracer as make_tracer_j
from bvh_tpu.ops.trace import trace_any_hit_tight as any_j
from bvh_tpu.ops.trace import trace_closest_hit_tight as trace_j
from bvh_tpu_torch import Ray, ray_intersects_triangle
from bvh_tpu_torch import obs
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import cluster as cluster_t
from bvh_tpu_torch.ops import (build_tight_scene, make_tracer,
                               sort_rays_device, trace_any_hit_tight,
                               trace_closest_hit_tight)
from bvh_tpu_torch.ops import sweep as sweep_mod
from bvh_tpu_torch.ops import tight as tight_mod
from bvh_tpu_torch.ops import trace as trace_mod
from bvh_tpu_torch.ops.trace import _dev, _ray_rows
from test_torch_dynamic import _oracle64
from test_torch_scene import assert_a_lo
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
N_CUBES = 40
PACKET = 512
GRAZING_RTOL = 3e-3
# hits where the exact reference's t lies more than a key step from
# float64's (its rounded o - cc), measured on the test's rays, by W
N_FAR_REFERENCE = {16: 0, 32: 19}  # of 513 hits at W=32
N_FAR_BMAT = {16: 0, 32: 18}  # of 512 hits at W=32


@pytest.fixture(scope="module")
def world():
    a, b, c = tb.create_n_cubes(N_CUBES)
    o1, d1 = tb.create_rays(256, seed=tb.seed_state_after(N_CUBES))
    o2, d2 = tb.aimed_rays(a, 512, seed=3)
    rng = np.random.default_rng(7)
    centers = (a + b + c) / np.float32(3)
    o3 = (centers[rng.integers(0, len(a), 256)]
          + rng.uniform(-20, 20, (256, 3))).astype(np.float32)
    d3 = rng.normal(size=(256, 3)).astype(np.float32)
    return (a, b, c), np.concatenate([o1, o2, o3]), np.concatenate([d1, d2, d3])


@pytest.fixture
def exact_reciprocal(monkeypatch):
    """The reference's approximate reciprocal (bfloat16 in interpret mode)
    made exact for one test; compiled traces are dropped before and after."""
    jax.clear_caches()
    monkeypatch.setattr(pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _assert_scene_equal(sj, st, a):
    """Every field of the reference's scene ``sj`` equal in the port's
    ``st``, which carries the exact-frame table of vertices ``a``."""
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


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_tie_class(ref, got, W, t64=None, n_far=0):
    """``ref``/``got``: (t, shape_id) numpy pairs. Hit masks equal; where
    the ids agree, t bits equal but on at most 1% of the hits, which may
    sit one key step (W ulps) apart; ids differ on at most 1% of the hits,
    each with t within ``GRAZING_RTOL``.

    ``t64``: the float64 oracle's t (``test_torch_dynamic._oracle64``).
    Where the ids agree but the reference's t lies more than a key step
    from float64's, the reference has rounded ``o - cc`` at a cluster
    frame far from the ray (a W=32 cluster box may span cubes ~1e5 apart),
    which the port's exact frame does not: there the port's t is held to
    float64's, within one key step, instead of to the reference's. There
    must be ``n_far`` such rays, the count measured on the test's rays."""
    (t_r, s_r), (t_g, s_g) = ref, got
    hit = np.isfinite(t_r)
    assert (np.isfinite(t_g) == hit).all()
    assert ((s_r >= 0) == hit).all() and ((s_g >= 0) == hit).all()
    same = hit & (s_r == s_g)
    far = np.zeros_like(same)
    if t64 is not None:
        b64 = _bits(t64.astype(np.float32)).astype(np.int64)
        far = same & (np.abs(_bits(t_r) - b64) > W)
        assert far.sum() == n_far
        assert (np.abs(_bits(t_g)[far] - b64[far]) <= W).all()
        same &= ~far
    step = np.abs(_bits(t_r)[same].astype(np.int64) - _bits(t_g)[same])
    assert (step <= W).all() and (step != 0).sum() <= max(2, hit.sum() // 100)
    diff = hit & (s_r != s_g)
    assert diff.sum() <= max(8, hit.sum() // 100)
    np.testing.assert_allclose(t_g[diff], t_r[diff], rtol=GRAZING_RTOL)


# ---- scene builds -----------------------------------------------------------

@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("kwargs", [
    {"packed": True}, {"bmat": True}, {"sweep_cut": 32},
    {"packed": True, "sweep_cut": 64, "leaf_size": 32},
    {"bmat": True, "wide": False, "leaf_size": 64}])
def test_build_options_equal(world, use_native, kwargs):
    tris = world[0]
    sj = build_j(*tris, use_native=use_native, **kwargs)
    st = build_tight_scene(*tris, use_native=use_native, **kwargs)
    _assert_scene_equal(sj, st, tris[0])


def test_bf16_helpers_equal():
    x = np.array([0.0, -0.0, 1.0, -1.0, 1.00390625, -3.3e-3, 1.2e5, -7.7e4,
                  1e30, -1e30, 1e-40, -1e-40, 65504.1, np.pi], np.float32)
    x = np.concatenate([x, np.random.default_rng(0).normal(
        scale=1e4, size=200).astype(np.float32)])
    for fn in ("_bf16_round_down", "_bf16_round_up"):
        assert np.array_equal(getattr(cluster_t, fn)(x).view(np.int32),
                              getattr(cluster_j, fn)(x).view(np.int32)), fn
    table = np.stack([x[:64], x[64:128], x[128:192], x[:64] + 5, x[64:128] + 5,
                      x[128:192] + 5, np.arange(64.0), np.arange(64.0)])
    table = table.astype(np.float32)
    pj = cluster_j.pack_node_table_bf16(table)
    pt = cluster_t.pack_node_table_bf16(table)
    assert np.array_equal(pj.view(np.int32), pt.view(np.int32))
    assert np.array_equal(cluster_j.unpack_node_table_bf16(pj),
                          cluster_t.unpack_node_table_bf16(pt))
    unpacked = sweep_mod.unpack_nodes(torch.from_numpy(pt)).numpy()
    assert np.array_equal(unpacked[[0, 1, 2, 3, 4, 5, 6, 7]],
                          cluster_t.unpack_node_table_bf16(pt))


@pytest.mark.parametrize("W", [16, 32, 64, 128])
def test_bilinear_tables_equal(W):
    rng = np.random.default_rng(W)
    C = 5
    av, e1, e2 = (rng.normal(size=(C * W, 3)) for _ in range(3))
    bj = cluster_j.bilinear_blocks(av, e1, e2)
    bt = cluster_t.bilinear_blocks(av, e1, e2)
    assert np.array_equal(bj, bt)
    assert np.array_equal(cluster_j.pack_bgroups(bj, C, W),
                          cluster_t.pack_bgroups(bt, C, W))


# ---- the entry/exit walk ----------------------------------------------------

@pytest.mark.parametrize("W", [16, 32])
def test_entry_exit_walk_matches_reference(world, W, exact_reciprocal):
    tris, o, d = world
    sj = build_j(*tris, leaf_size=W, wide=False)
    st = build_tight_scene(*tris, leaf_size=W, wide=False)
    hj = trace_j(sj, bvh_tpu.Ray.create(o, d), interpret=True, packet=PACKET)
    before = obs.counted("launch.tight_trace")
    ht = trace_closest_hit_tight(st, Ray.create(o, d, device=CPU),
                                 packet=PACKET, device=CPU)
    # the CPU runs the plain version
    assert obs.counted("launch.tight_trace") == before
    got = (ht.t.numpy(), ht.shape_id.numpy())
    assert_tie_class((np.asarray(hj.t), np.asarray(hj.shape_id)), got, W,
                     _oracle64(o, d, *tris)[0], N_FAR_REFERENCE[W])
    assert 0.4 < np.isfinite(got[0]).mean() < 0.9
    # the group walk over the same tree gives the same bits
    hw = trace_closest_hit_tight(build_tight_scene(*tris, leaf_size=W),
                                 Ray.create(o, d, device=CPU), packet=PACKET,
                                 wide=True, device=CPU)
    assert np.array_equal(_bits(hw.t), _bits(got[0]))
    assert np.array_equal(hw.shape_id.numpy(), got[1])


@pytest.mark.parametrize("use_native", [True, False])
def test_packed_scene_traces_correctly(use_native):
    """The reference's packed test (tests/test_tight_kernel.py:309-345) on
    the port, and the port against the reference's packed trace."""
    a, b, c = tb.create_n_cubes(50)
    s32 = build_tight_scene(a, b, c, use_native=use_native)
    sp = build_tight_scene(a, b, c, use_native=use_native, packed=True)
    assert sp.packed_nodes.shape[0] == 5 and sp.gnodes is None
    centers = a.reshape(-1, 12, 3).mean(axis=1)
    n = 1024
    idx = np.resize(np.arange(len(centers)), n)
    rng = np.random.default_rng(7)
    offs = rng.normal(size=(n, 3)).astype(np.float32)
    offs /= np.linalg.norm(offs, axis=1, keepdims=True)
    o = (centers[idx] + offs * 40.0).astype(np.float32)
    d = (centers[idx] + 0.15 - o).astype(np.float32)
    flip = rng.random(n) < 0.3
    d[flip] = offs[flip]
    rays = Ray.create(o, d, device=CPU)
    got = trace_closest_hit_tight(sp, rays, packet=128, device=CPU)
    tg = got.t.numpy()
    a_, b_, c_ = (torch.from_numpy(x)[None] for x in (a, b, c))
    tw = ray_intersects_triangle(Ray(*(x[:, None] for x in rays)), a_, b_,
                                 c_).distance.amin(dim=1).numpy()
    assert (np.isfinite(tg) == np.isfinite(tw)).all()
    both = np.isfinite(tg)
    np.testing.assert_allclose(tg[both], tw[both], rtol=5e-3)
    assert (np.abs(tg[both] / tw[both] - 1) < 3e-3).mean() > 0.97
    got2 = trace_closest_hit_tight(sp, rays, packet=128, sweep=True,
                                   device=CPU)
    assert np.array_equal(_bits(got2.t), _bits(tg))
    ref = trace_closest_hit_tight(s32, rays, packet=128, device=CPU)
    same = ref.shape_id.numpy() == got.shape_id.numpy()
    assert same.mean() > 0.9
    np.testing.assert_allclose(tg[both & same], ref.t.numpy()[both & same],
                               rtol=2e-4)
    # the reference's packed trace: the same masks, ids up to the tie class
    sj = build_j(a, b, c, use_native=use_native, packed=True)
    hj = trace_j(sj, bvh_tpu.Ray.create(o, d), packet=128, interpret=True)
    hit = np.isfinite(np.asarray(hj.t))
    assert (hit == both).all()
    assert (np.asarray(hj.shape_id) != got.shape_id.numpy()).sum() <= max(
        8, hit.sum() // 100)


@pytest.mark.parametrize("leaf", [16, 32])
def test_bmat_scene_matches_default(leaf, exact_reciprocal):
    """The reference's bmat test (tests/test_tight_kernel.py:259-283) on the
    port: the bmat trace against the default scene's at t rtol 1e-5 with
    equal ids (here bit for bit); and against the reference's bmat trace up
    to its tie class."""
    a, b, c = tb.create_n_cubes(30)
    sc_def = build_tight_scene(a, b, c, leaf_size=leaf, use_native=False)
    sc_bm = build_tight_scene(a, b, c, leaf_size=leaf, use_native=False,
                              bmat=True)
    assert sc_bm.bgroups is not None and sc_def.bgroups is None
    centers = a.reshape(-1, 12, 3).mean(axis=1)
    n = 512
    idx = np.resize(np.arange(len(centers)), n)
    rng = np.random.default_rng(5)
    offs = rng.normal(size=(n, 3)).astype(np.float32)
    offs /= np.linalg.norm(offs, axis=1, keepdims=True)
    o = (centers[idx] + offs * 30.0).astype(np.float32)
    d = (centers[idx] + 0.19 - o).astype(np.float32)
    rays = Ray.create(o, d, device=CPU)
    got = trace_closest_hit_tight(sc_bm, rays, packet=128, device=CPU)
    want = trace_closest_hit_tight(sc_def, rays, packet=128, device=CPU)
    assert (got.shape_id == want.shape_id).all()
    assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
    ref = trace_j(build_j(a, b, c, leaf_size=leaf, use_native=False,
                          bmat=True), bvh_tpu.Ray.create(o, d), packet=128,
                  interpret=True)
    assert np.isfinite(got.t.numpy()).mean() > 0.9
    assert_tie_class((np.asarray(ref.t), np.asarray(ref.shape_id)),
                     (got.t.numpy(), got.shape_id.numpy()), leaf,
                     _oracle64(o, d, a, b, c)[0], N_FAR_BMAT[leaf])


def test_tight_kernel_wrapper(world):
    tris, o, d = world
    st = build_tight_scene(*tris, packed=True, sweep_cut=64)
    rows = _ray_rows(Ray.create(o, d, device=CPU), torch.full((len(o),), np.inf))
    pn = _dev(st.packed_nodes, CPU)
    pr = _dev(st.packed_nodes, CPU, sweep_mod.node_records)
    sn = _dev(st.smem_nodes, CPU, sweep_mod.node_records)
    grp = _dev(st.groups, CPU)
    t0, i0 = tight_mod.tight_trace(pr, grp, rows, st.width, packed=True)
    t1, i1, visits, fires = tight_mod.tight_trace_plain(
        pn, grp, rows, st.width, packed=True, counts=True)
    assert torch.equal(t0.view(torch.int32), t1.view(torch.int32))
    assert torch.equal(i0, i1)
    assert (visits >= 1).all() and (fires <= visits).all() and fires.sum() > 0
    # the kernels read the records, not the [5, Nn] or [8, Nn] table
    with pytest.raises(ValueError, match=r"records must be \[Nn, 8\]"):
        tight_mod.tight_trace(pn, grp, rows, st.width, packed=True)
    with pytest.raises(ValueError, match=r"records must be \[Nn, 8\]"):
        tight_mod.tight_trace(_dev(st.smem_nodes, CPU), grp, rows, st.width)
    with pytest.raises(ValueError, match="mode"):
        tight_mod.tight_trace(sn, grp, rows, st.width, mode="nearest")
    with pytest.raises(ValueError, match="hints"):
        tight_mod.tight_trace(sn, grp, rows, st.width, packet=PACKET,
                              hints=torch.zeros(1, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="width"):
        tight_mod.tight_trace(sn, grp, rows, 8)
    # a wide=True override needs an f32 wide scene
    rays = Ray.create(o, d, device=CPU)
    with pytest.raises(ValueError, match="gnodes"):
        trace_closest_hit_tight(st, rays, wide=True, device=CPU)
    with pytest.raises(ValueError, match="bmat"):
        trace_any_hit_tight(build_tight_scene(*tris, bmat=True), rays,
                            wide=True, device=CPU)


# ---- any hit ----------------------------------------------------------------

@pytest.mark.parametrize("walk", ["wide", "entry_exit", "packed"])
@pytest.mark.parametrize("bound", ["none", "scalar", "per_ray", "per_ray_perm"])
def test_any_hit_matches_reference(world, walk, bound):
    tris, o, d = world
    kw = {"wide": {}, "entry_exit": {"wide": False},
          "packed": {"packed": True}}[walk]
    sj, st = build_j(*tris, **kw), build_tight_scene(*tris, **kw)
    n = len(o)
    t_max = {"none": None, "scalar": np.float32(45.0)}.get(
        bound, np.random.default_rng(8).uniform(5, 80, n).astype(np.float32))
    perm = None
    if bound == "per_ray_perm":
        perm, _ = sort_rays_device(o, d, mode="morton", device=CPU)
    ref = np.asarray(any_j(sj, bvh_tpu.Ray.create(o, d), t_max=t_max,
                           packet=PACKET, interpret=True,
                           perm=None if perm is None
                           else np.asarray(perm, np.int32)))
    got = trace_any_hit_tight(st, Ray.create(o, d, device=CPU), t_max=t_max,
                              packet=PACKET, perm=perm, device=CPU)
    assert got.dtype == torch.bool and got.shape == (n,)
    got = got.numpy()
    assert 0 < got.sum() < n
    # the closest hit decides the occlusion, up to the key truncation
    hc = trace_closest_hit_tight(st, Ray.create(o, d, device=CPU), tris=tris,
                                 perm=perm, device=CPU)
    tc = hc.t.numpy()
    tm = np.broadcast_to(np.inf if t_max is None else t_max, (n,))
    if perm is not None:
        tm = tm[perm.numpy()]
    gap = np.abs(tc - np.where(np.isfinite(tm), tm, 0.0))  # |t - t_max|
    near = np.isfinite(tm) & (gap <= GRAZING_RTOL * tm)
    assert near.sum() <= 4
    assert np.array_equal(got[~near], (tc < tm)[~near])
    # the reference's t carries its approximate reciprocal (2^-8 relative
    # in interpret mode)
    band = np.isfinite(tm) & (gap <= (GRAZING_RTOL + 2**-8) * tm)
    assert band.sum() <= 8
    assert np.array_equal(ref[~band], got[~band])


@pytest.mark.parametrize("walk", ["wide", "entry_exit"])
def test_any_hit_sweep_and_pre_gate(world, walk):
    tris, o, d = world
    st = build_tight_scene(*tris, wide=walk == "wide")
    rays = Ray.create(o, d, device=CPU)
    base = trace_any_hit_tight(st, rays, t_max=60.0, packet=128, device=CPU)
    swept = trace_any_hit_tight(st, rays, t_max=60.0, packet=128, sweep=True,
                                device=CPU)
    assert torch.equal(base, swept)
    pg = np.random.default_rng(2).integers(0, 2, len(o) // 128)
    gated = trace_any_hit_tight(st, rays, t_max=60.0, packet=128,
                                pre_gate=pg, sweep=True, device=CPU)
    on = torch.from_numpy(np.repeat(pg, 128) != 0)
    assert torch.equal(gated, base & on)


# ---- hints and pre-gates ----------------------------------------------------

@pytest.mark.parametrize("kwargs", [{}, {"wide": False}, {"packed": True}])
def test_reference_seed_hints_change_nothing(world, kwargs):
    tris, o, d = world
    sj, st = build_j(*tris, **kwargs), build_tight_scene(*tris, **kwargs)
    packet = 512
    hints = compute_seed_hints(sj, bvh_tpu.Ray.create(o, d), packet=packet,
                               sample_stride=32, k_hints=8, interpret=True)
    hints = np.array(hints)
    assert (hints[:, 0] >= 0).any()
    hints[0] = -1  # the first packet without hints
    rays = Ray.create(o, d, device=CPU)
    plain = trace_closest_hit_tight(st, rays, tris=tris, packet=packet,
                                    device=CPU)
    seeded = trace_closest_hit_tight(st, rays, tris=tris, packet=packet,
                                     hints=hints, device=CPU)
    assert torch.equal(plain.t.view(torch.int32), seeded.t.view(torch.int32))
    assert torch.equal(plain.shape_id, seeded.shape_id)
    if not kwargs:
        with pytest.raises(ValueError, match="default walk"):
            trace_closest_hit_tight(st, rays, packet=packet, hints=hints,
                                    wide=False, device=CPU)


@pytest.mark.parametrize("walk", ["wide", "entry_exit"])
@pytest.mark.parametrize("sweep", [False, True])
def test_pre_gate_matches_reference(world, walk, sweep):
    tris, o, d = world
    kw = {} if walk == "wide" else {"wide": False}
    sj, st = build_j(*tris, **kw), build_tight_scene(*tris, **kw)
    p = len(o) // PACKET
    pg = np.array([1, 0, 1, 0][:p], np.int32)
    ref = trace_j(sj, bvh_tpu.Ray.create(o, d), packet=PACKET, sweep=sweep,
                  pre_gate=jnp.asarray(pg), interpret=True)
    got = trace_closest_hit_tight(st, Ray.create(o, d, device=CPU),
                                  packet=PACKET, sweep=sweep, pre_gate=pg,
                                  device=CPU)
    free = trace_closest_hit_tight(st, Ray.create(o, d, device=CPU),
                                   packet=PACKET, device=CPU)
    on = np.repeat(pg, PACKET) != 0
    assert np.array_equal(np.isfinite(got.t.numpy()),
                          np.isfinite(free.t.numpy()) & on)
    assert np.array_equal(_bits(got.t)[on], _bits(free.t)[on])
    assert np.array_equal(np.isfinite(np.asarray(ref.t)),
                          np.isfinite(got.t.numpy()))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("pre", [False, True])
def test_sweep_matches_reference(world, packed, pre):
    tris, o, d = world
    n, packet = len(o), 128
    t_max = np.random.default_rng(4).uniform(0, 100, n).astype(np.float32)
    sj = build_j(*tris, packed=packed)
    st = build_tight_scene(*tris, packed=packed)
    _, _, slab, _ = _pack_rays_tight(bvh_tpu.Ray.create(o, d), packet, t_max)
    pg = np.resize(np.array([1, 1, 0], np.int32), n // packet) if pre else None
    table_j = sj.packed_nodes if packed else sj.smem_nodes
    fired = _sweep_tight(jnp.asarray(table_j), slab,
                         num_nodes=int(table_j.shape[1]), interpret=True,
                         packet=packet, packed=packed,
                         pre_gate=None if pg is None else jnp.asarray(pg))
    gate_j = (np.asarray(fired)[:, 0, 0] > 0).astype(np.int32)
    rows = _ray_rows(Ray.create(o, d, device=CPU), torch.from_numpy(t_max))
    table_t = st.packed_nodes if packed else st.smem_nodes
    gate_t = sweep_mod.sweep_gate(
        _dev(table_t, CPU, sweep_mod.node_records), rows, packet,
        packed=packed, pre_gate=None if pg is None else torch.from_numpy(pg))
    assert np.array_equal(gate_j, gate_t.numpy())
    assert 0 < gate_j.sum() < len(gate_j)


# ---- make_tracer on scenes without a wide table -----------------------------

@pytest.mark.parametrize("kwargs", [{"wide": False}, {"packed": True}])
def test_make_tracer_matches_reference(world, kwargs, exact_reciprocal):
    tris, o, d = world
    sj, st = build_j(*tris, **kwargs), build_tight_scene(*tris, **kwargs)
    ref = make_tracer_j(sj, packet=PACKET, sort="morton", interpret=True)(o, d)
    got = make_tracer(st, packet=PACKET, sort="morton", device=CPU)(o, d)
    assert_tie_class((np.asarray(ref.t), np.asarray(ref.shape_id)),
                     (got.t.numpy(), got.shape_id.numpy()), st.width)
    # the sweep gate and the sort change no bit
    got2 = make_tracer(st, packet=128, sweep=False, sort=None,
                       device=CPU)(o, d)
    assert torch.equal(got.t.view(torch.int32), got2.t.view(torch.int32))
    assert torch.equal(got.shape_id, got2.shape_id)


# ---- the kernels' node records and the sweep's least work -------------------

@pytest.mark.parametrize("name", ["smem_nodes", "packed_nodes", "sweep_nodes"])
def test_node_records_hold_the_table(world, name):
    """The kernels' node-major copy of an entry/exit table holds the
    table's own words (box lo, box hi, entry, exit; a packed table's raw
    pair words, then zeros) and gives the table back bit for bit."""
    tris, _, _ = world
    st = build_tight_scene(*tris, packed=True, sweep_cut=64)
    table = getattr(st, name)
    packed = name == "packed_nodes"
    rec = sweep_mod.node_records(table)
    assert rec.dtype == np.float32 and rec.shape == (table.shape[1], 8)
    assert rec.flags.c_contiguous
    if packed:
        assert np.array_equal(rec[:, 0:3].view(np.int32),
                              table[0:3].T.view(np.int32))
        assert not rec[:, 3:6].any()
        assert np.array_equal(rec[:, 6:8], table[3:5].T)
    else:
        assert np.array_equal(rec.view(np.int32), table.T.view(np.int32))
    back = sweep_mod.node_table(_dev(table, CPU, sweep_mod.node_records),
                                packed)
    assert back.is_contiguous()
    assert np.array_equal(back.numpy().view(np.int32), table.view(np.int32))
    with pytest.raises(ValueError, match="5 or 8 rows"):
        sweep_mod.node_records(table[:4])


@pytest.mark.parametrize("packed", [False, True])
def test_records_path_equals_the_table_walks(world, packed):
    """The wrappers on records (gated, hinted, any-bounded) give the plain
    walks' bits over the table itself."""
    tris, o, d = world
    st = build_tight_scene(*tris, packed=packed, wide=False)
    table = st.packed_nodes if packed else st.smem_nodes
    tab, rec = _dev(table, CPU), _dev(table, CPU, sweep_mod.node_records)
    grp = _dev(st.groups, CPU)
    n, packet = len(o), 128
    t_max = np.random.default_rng(5).uniform(0, 100, n).astype(np.float32)
    rows = _ray_rows(Ray.create(o, d, device=CPU), torch.from_numpy(t_max))
    pre = torch.from_numpy(np.resize(np.array([1, 0, 1], np.int32),
                                     -(-n // packet)))
    g_r = sweep_mod.sweep_gate(rec, rows, packet, packed=packed, pre_gate=pre)
    g_t = sweep_mod.sweep_gate_plain(tab, rows, packet, packed=packed,
                                     pre_gate=pre)
    assert torch.equal(g_r, g_t) and 0 < int(g_r.sum()) < g_r.numel()
    leaves = np.nonzero(table[3 if packed else 6] < 0)[0]
    hints = np.random.default_rng(6).choice(leaves, (g_r.numel(), 3))
    hints = torch.from_numpy(hints.astype(np.int32))
    hints[::2, 0] = -1
    for kw in ({"gate": g_r, "hints": hints},
               {"mode": "any", "bounded": True}):
        got = tight_mod.tight_trace(rec, grp, rows, st.width, packed=packed,
                                    packet=packet, **kw)
        want = tight_mod.tight_trace_plain(tab, grp, rows, st.width,
                                           packed=packed, packet=packet, **kw)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])


def _brute_least_tests(table, rows, packet, pre):
    """The sweep's least work by a scalar walk of every ray in numpy: a
    packet that fires costs its shortest walk to a fire, one that does not
    every ray's whole walk; pre-gated packets cost nothing."""
    nn = table.shape[1]
    ax, ay, az, bx, by, bz, entry, exit_ = table
    r = rows.numpy()
    n = r.shape[1]
    tests, open_rays = 0, 0
    for s in range(0, n, packet):
        if pre is not None and pre[s // packet] == 0:
            continue
        walks = []
        for i in range(s, min(s + packet, n)):
            oix, oiy, oiz, ix, iy, iz, tmx = r[0:7, i]
            cur, steps, fired = 0, 0, False
            while cur < nn:
                steps += 1
                t1, t2 = ax[cur] * ix - oix, bx[cur] * ix - oix
                u1, u2 = ay[cur] * iy - oiy, by[cur] * iy - oiy
                v1, v2 = az[cur] * iz - oiz, bz[cur] * iz - oiz
                tmin = np.maximum(np.maximum(np.minimum(t1, t2),
                                             np.minimum(u1, u2)),
                                  np.minimum(v1, v2))
                tmax = np.minimum(np.minimum(np.maximum(t1, t2),
                                             np.maximum(u1, u2)),
                                  np.maximum(v1, v2))
                useful = (tmax >= np.maximum(tmin, np.float32(0))) and tmin < tmx
                if useful and entry[cur] < 0:
                    fired = True
                    break
                cur = int(entry[cur] if useful else exit_[cur])
            walks.append((fired, steps))
        firing = [k for f, k in walks if f]
        if firing:
            tests += min(firing)
        else:
            tests += sum(k for _, k in walks)
            open_rays += len(walks)
    return tests, open_rays


@pytest.mark.parametrize("pre", [False, True])
def test_least_node_tests_matches_a_brute_count(world, pre):
    """The sweep's bound charges a fired packet its shortest firing walk
    and an unfired one every walk, as a scalar walk of every ray counts."""
    tris, o, d = world
    st = build_tight_scene(*tris)
    n, packet = len(o), 128
    t_max = np.random.default_rng(8).uniform(0, 60, n).astype(np.float32)
    rows = _ray_rows(Ray.create(o, d, device=CPU), torch.from_numpy(t_max))
    p = -(-n // packet)
    pg = (torch.from_numpy(np.resize(np.array([1, 1, 0], np.int32), p))
          if pre else None)
    tab = _dev(st.smem_nodes, CPU)
    per_ray = None if pg is None else pg.repeat_interleave(packet)[:n]
    fired, visits = sweep_mod.sweep_gate_plain(tab, rows, 1, counts=True,
                                               pre_gate=per_ray)
    got = sweep_mod.least_node_tests(visits, fired, packet, pre_gate=pg)
    want = _brute_least_tests(st.smem_nodes, rows, packet,
                              None if pg is None else pg.numpy())
    assert got == want
    gate = sweep_mod.sweep_gate_plain(tab, rows, packet, pre_gate=pg)
    assert 0 < int(gate.sum()) < p  # both kinds of packet are counted
    assert got[0] < int(visits.sum())  # fired packets cost less than before


# ---- skip_narrow: the broadphase-only walk ------------------------------------

@pytest.mark.parametrize("kwargs", [{}, {"wide": False}, {"packed": True}])
@pytest.mark.parametrize("bound", [None, "per_ray"])
def test_skip_narrow_misses_every_ray(world, kwargs, bound):
    """Every ray misses, in the port (with the exact recompute asked for,
    a t_max, hints and the sweep, neither of which it reads) and in the
    reference's interpret-mode trace."""
    tris, o, d = world
    sj, st = build_j(*tris, **kwargs), build_tight_scene(*tris, **kwargs)
    t_max = None if bound is None else np.linspace(5.0, 2e5, len(o),
                                                   dtype=np.float32)
    p = -(-len(o) // PACKET)
    got = trace_closest_hit_tight(
        st, Ray.create(o, d, device=CPU), tris=tris, packet=PACKET,
        t_max=t_max, sweep=True, skip_narrow=True,
        hints=np.full((p, 2), 7, np.int32), device=CPU)
    assert torch.isinf(got.t).all() and (got.t > 0).all()
    assert (got.shape_id == -1).all()
    assert not got.u.any() and not got.v.any()
    ref = trace_j(sj, bvh_tpu.Ray.create(o, d), packet=PACKET,
                  t_max=None if t_max is None else jnp.asarray(t_max),
                  skip_narrow=True, interpret=True)
    assert not np.isfinite(np.asarray(ref.t)).any()
    assert (np.asarray(ref.shape_id) == -1).all()


def test_skip_narrow_follows_the_references_rules(world, monkeypatch):
    """The entry/exit walk's SKIP build whatever the scene's default walk;
    ``wide=True`` and ``start_g`` raise; the sweep never runs; the
    pre-gate reaches the walk."""
    tris, o, d = world
    st = build_tight_scene(*tris)
    rays = Ray.create(o, d, device=CPU)
    with pytest.raises(ValueError, match="skip_narrow"):
        trace_closest_hit_tight(st, rays, packet=PACKET, wide=True,
                                skip_narrow=True, device=CPU)
    p = -(-len(o) // PACKET)
    with pytest.raises(ValueError, match="start_g"):
        trace_closest_hit_tight(st, rays, packet=PACKET, skip_narrow=True,
                                start_g=np.ones(p, np.int32), device=CPU)
    seen = []

    def no_sweep(*args, **kw):
        raise AssertionError("skip_narrow ran the sweep gate")

    def walk(*args, **kw):
        seen.append(kw)
        return tight_mod.tight_trace(*args, **kw)

    monkeypatch.setattr(trace_mod, "sweep_gate", no_sweep)
    monkeypatch.setattr(trace_mod, "tight_trace", walk)
    pg = np.array([1, 0, 1, 0][:p], np.int32)
    got = trace_closest_hit_tight(st, rays, packet=PACKET, sweep=True,
                                  skip_narrow=True, pre_gate=pg, device=CPU)
    assert torch.isinf(got.t).all()
    (kw,) = seen
    assert kw["skip_narrow"] and kw["hints"] is None
    assert torch.equal(kw["gate"], torch.as_tensor(pg))


def test_skip_narrow_counts_on_uniform_packets():
    """Packets of one ray repeated (aimed and reference-random rays): the
    plain SKIP walk's visit sums are exactly packet x the reference's
    ``_trace_tight(skip_narrow=True, count_visits=True)`` count, every
    count at least the full walk's, and neither counts a fire."""
    a, b, c = tb.create_n_cubes(60)
    sj = cluster_j.build_tight_scene(a, b, c, wide=False)
    st = build_tight_scene(a, b, c, wide=False)
    o1, d1 = tb.aimed_rays(a, 8, seed=6)
    o2, d2 = tb.create_rays(4, seed=tb.seed_state_after(3))
    o = np.repeat(np.concatenate([o1, o2]), PACKET, axis=0)
    d = np.repeat(np.concatenate([d1, d2]), PACKET, axis=0)
    p, _, slab, lmat = _pack_rays_tight(
        bvh_tpu.Ray.create(jnp.asarray(o), jnp.asarray(d)), PACKET, None)
    zeros = jnp.zeros((p,), jnp.int32)
    sn = jnp.asarray(sj.smem_nodes)
    out = _trace_tight(sn, zeros, zeros, jnp.asarray(sj.groups), slab, lmat,
                       num_nodes=int(sn.shape[1]), interpret=True,
                       packet=PACKET, skip_narrow=True, width=int(sj.width),
                       count_visits=True)
    visits_j = np.asarray(out[:, 0, 0]).astype(np.int64)
    fires_j = np.asarray(out[:, 1, 0]).astype(np.int64)
    rows = _ray_rows(Ray.create(o, d, device=CPU),
                     torch.full((len(o),), np.inf))
    rec = _dev(st.smem_nodes, CPU, sweep_mod.node_records)
    grp = _dev(st.groups, CPU)
    t, lane, visits, fires = tight_mod.tight_trace(
        rec, grp, rows, st.width, packet=PACKET, counts=True,
        skip_narrow=True)
    assert torch.isinf(t).all() and (lane == -1).all()
    sums = visits.view(-1, PACKET).sum(dim=1).numpy()
    assert (visits_j > 0).all() and np.array_equal(PACKET * visits_j, sums)
    assert not fires_j.any() and not fires.any()
    _, _, full, full_fires = tight_mod.tight_trace(rec, grp, rows, st.width,
                                                   counts=True)
    assert (visits >= full).all() and (visits > full).any()
    assert full_fires.sum() > 0
