"""Subtree entry (the two-phase group walk), the seeders and the planners
of the port against ``bvh_tpu`` (Pallas in interpret mode), on
create_n_cubes(600) at W=16: a wide table three levels deep whose root has
four interior children, so single and two-entry plans both engage.

* ``wide_group_meta``, ``make_key_planner``, ``make_seeder``,
  ``compute_seed_hints`` and ``make_planner``: array-equal to the
  reference's (the seeders and the planner trace a sample first, so the
  reference runs with its reciprocal made exact, as in
  ``tests/test_torch_wide.py``).
* ``trace_closest_hit_tight(start_g=)``: for any entries (inert, single,
  equal, nested both ways, random pairs, the planners'), plain, hinted and
  gated, and bounded, bit-equal to the port's trace without them; against
  the reference's trace with the same entries (three kinds, plain and with
  hints, gate and bound together), hit masks equal, raw t within the key
  truncation (2·W·2^-23 relative), ids equal outside the near-tie class
  (at most 1% of the hits).
* The entry points: the seeded trace and ``make_tracer(plan="key")`` equal
  their unplanned twins bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bvh_tpu
from bvh_tpu.ops.cluster import build_tight_scene as build_j
from bvh_tpu.ops.cluster import wide_group_meta as wide_group_meta_j
from bvh_tpu.ops.trace import compute_seed_hints as compute_seed_hints_j
from bvh_tpu.ops.trace import make_key_planner as make_key_planner_j
from bvh_tpu.ops.trace import make_planner as make_planner_j
from bvh_tpu.ops.trace import make_seeder as make_seeder_j
from bvh_tpu.ops.trace import trace_closest_hit_tight as trace_j
from bvh_tpu_torch import Ray
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import (build_tight_scene, compute_seed_hints,
                               make_key_planner, make_planner, make_seeder,
                               make_tracer, sort_rays_device,
                               trace_closest_hit_seeded,
                               trace_closest_hit_tight)
from bvh_tpu_torch.ops import wide as wide_mod
from bvh_tpu_torch.ops.cluster import wide_group_meta
from bvh_tpu_torch.ops.trace import _ray_rows
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
N_CUBES = 600
PACKET = 512
W = 16
KEY_TOL = 2 * W * 2.0 ** -23  # the packed key's truncation of raw t
GRAZING_RTOL = 3e-3  # PARITY.md's grazing-edge class


def _coherent(a, n, seed=3):
    """n rays from 5 units around the first 16 cubes, aimed at them."""
    return tb.aimed_rays(a[:12 * 16], n, seed=seed, dist=5.0)


@pytest.fixture(scope="module")
def world():
    a, b, c = tb.create_n_cubes(N_CUBES)
    st = build_tight_scene(a, b, c)
    sj = build_j(a, b, c)
    o1, d1 = _coherent(a, 1024)
    o2, d2 = tb.aimed_rays(a, 512, seed=4)
    o3, d3 = tb.create_rays(512, seed=tb.seed_state_after(N_CUBES))
    o = np.concatenate([o1, o2, o3])
    d = np.concatenate([d1, d2, d3])
    perm = sort_rays_device(o, d, mode="morton", device=CPU)[0].numpy()
    o, d = o[perm], d[perm]
    return (a, b, c), st, sj, o, d


def _real_groups(scene):
    parent = wide_group_meta(scene.gnodes)[0]
    return np.nonzero((parent >= 0) | (np.arange(len(parent)) == 0))[0]


def _entries(scene, p: int, kind: str, seed: int = 0):
    """[p, 2] (or [p] for "single") int32 subtree entries of one kind."""
    parent, depth, _ = wide_group_meta(scene.gnodes)
    real = _real_groups(scene)
    deep = real[depth[real] >= 2]
    rng = np.random.default_rng(seed)
    sg = rng.choice(real, size=(p, 2))
    if kind == "inert":
        sg[:] = -1
    elif kind == "single":
        return sg[:, 0].astype(np.int32)
    elif kind == "equal":
        sg[:, 1] = sg[:, 0]
    elif kind == "nested_up":  # the second entry an ancestor of the first
        sg[:, 0] = rng.choice(deep, p)
        sg[:, 1] = parent[sg[:, 0]]
    elif kind == "nested_down":  # the second inside the first
        sg[:, 1] = rng.choice(deep, p)
        sg[:, 0] = parent[sg[:, 1]]
    elif kind == "second_only":
        sg[:, 0] = -1
    return sg.astype(np.int32)


KINDS = ["inert", "single", "equal", "nested_up", "nested_down",
         "second_only", "random"]
OPTIONS = ["plain", "hinted_gated", "bounded"]
# the options under which the reference traces the same entries (one
# compile each in interpret mode)
REF_KINDS = ["nested_up", "single", "random"]
REF_OPTIONS = ["plain", "hinted_gated_bounded"]


def _options(st, n: int, option: str):
    p = -(-n // PACKET)
    kw = {}
    if option.startswith("hinted_gated"):
        h = np.random.default_rng(5).choice(st.gslot, size=(p, 3))
        h = h.astype(np.int32)
        h[1::3, 0] = -1
        kw.update(hints=h, pre_gate=np.resize([1, 1, 0], p).astype(np.int32))
    if option.endswith("bounded"):
        kw["t_max"] = np.random.default_rng(6).uniform(
            1.0, 120.0, n).astype(np.float32)
    return kw


def _port(st, o, d, **kw):
    h = trace_closest_hit_tight(st, Ray.create(o, d, device=CPU),
                                packet=PACKET, device=CPU, **kw)
    return h.t.numpy(), h.shape_id.numpy()


def _ref(sj, o, d, **kw):
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) and k != "t_max"
              else v) for k, v in kw.items()}
    h = trace_j(sj, bvh_tpu.Ray.create(o, d), packet=PACKET, interpret=True,
                **kw)
    return np.asarray(h.t), np.asarray(h.shape_id)


@pytest.fixture(scope="module")
def reference(world):
    """The reference's results, with its reciprocal made exact (the compiled
    traces are dropped before and after, so the patch takes hold and does
    not leak): traces with entries of three kinds, plain and with hints,
    gate and bound together, and the seeders' and the planner's outputs."""
    tris, st, sj, o, d = world
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jax.clear_caches()
        mp.setattr(pl, "reciprocal", lambda x, approx=False: 1.0 / x)
        p = -(-len(o) // PACKET)
        for option in REF_OPTIONS:
            for kind in REF_KINDS:
                sg = _entries(st, p, kind, seed=len(kind))
                out[option, kind] = _ref(sj, o, d, start_g=jnp.asarray(sg),
                                         **_options(st, len(o), option))
        rays_j = bvh_tpu.Ray.create(o, d)
        hints, start_g = make_planner_j(sj, packet=PACKET, interpret=True)(
            rays_j)
        out["planner"] = np.asarray(hints), np.asarray(start_g)
        out["seeder"] = np.asarray(make_seeder_j(sj, packet=PACKET,
                                                 interpret=True)(rays_j))
        out["seed_hints"] = np.asarray(compute_seed_hints_j(
            sj, rays_j, packet=PACKET, interpret=True))
    jax.clear_caches()
    return out


def _assert_matches_reference(ref, got):
    """Hit masks equal; raw t within the key truncation where the ids
    agree; ids differ on at most 1% of the hits, only in the near-tie and
    grazing-edge classes."""
    (t_j, sid_j), (t_t, sid_t) = ref, got
    hit = np.isfinite(t_j)
    assert (np.isfinite(t_t) == hit).all()
    assert ((sid_t >= 0) == hit).all()
    same = hit & (sid_j == sid_t)
    np.testing.assert_allclose(t_t[same], t_j[same], rtol=KEY_TOL)
    diff = hit & (sid_j != sid_t)
    np.testing.assert_allclose(t_t[diff], t_j[diff],
                               rtol=GRAZING_RTOL + KEY_TOL)
    assert diff.sum() <= max(8, hit.sum() // 100)


def _assert_same(x, y):
    (t0, s0), (t1, s1) = x, y
    assert np.array_equal(t0.view(np.int32), t1.view(np.int32))
    assert np.array_equal(s0, s1)


@pytest.mark.parametrize("which", ["cubes_w16", "cubes_w64", "chain_14"])
def test_wide_group_meta_matches_reference(world, which):
    (a, b, c), st, *_ = world
    if which == "cubes_w64":
        st = build_tight_scene(a, b, c, leaf_size=64)
    elif which == "chain_14":
        st = tb.chain_tables(st, 14)
    got = wide_group_meta(st.gnodes)
    ref = wide_group_meta_j(st.gnodes)
    for x, y in zip(got, ref):
        assert x.dtype == np.int64 and np.array_equal(x, np.asarray(y))
    parent, depth, anc = got
    if which == "cubes_w16":
        # the phases engage: two levels below the root, more than two
        # interior children of the root
        assert depth.max() >= 2 and (parent == 0).sum() > 2
    if which == "chain_14":
        assert depth.max() == 13 and (anc[13] == np.arange(14)).all()


@pytest.mark.parametrize("packet, rays", [(128, "coherent"),
                                          (512, "coherent"), (512, "mixed")])
def test_key_planner_matches_reference(world, packet, rays):
    (a, b, c), st, sj, o, d = world
    if rays == "coherent":
        o, d = _coherent(a, 2048)
        o = o[sort_rays_device(o, d, mode="morton", device=CPU)[0].numpy()]
    got = make_key_planner(st, packet=packet, device=CPU)(
        torch.from_numpy(o))
    assert got.dtype == torch.int32 and got.shape == (-(-len(o) // packet), 2)
    ref = np.asarray(make_key_planner_j(sj, packet=packet)(jnp.asarray(o)))
    assert np.array_equal(got.numpy(), ref)
    if rays == "coherent":
        # entries engage on packets around one or a few cubes, two at a
        # time on the wider packets
        assert (ref[:, 0] > 0).any()
        if packet == 512:
            assert (ref[:, 1] > 0).any()


def test_seeders_and_planner_match_reference(world, reference):
    tris, st, sj, o, d = world
    rays = Ray.create(o, d, device=CPU)
    hints = make_seeder(st, packet=PACKET, device=CPU)(rays)
    assert hints.dtype == torch.int32
    assert np.array_equal(hints.numpy(), reference["seeder"])
    assert np.array_equal(compute_seed_hints(st, rays, packet=PACKET,
                                             device=CPU),
                          reference["seed_hints"])
    ph, sg = make_planner(st, packet=PACKET, device=CPU)(rays)
    assert np.array_equal(ph.numpy(), reference["planner"][0])
    assert np.array_equal(sg.numpy(), reference["planner"][1])
    # single and two-entry plans both engage here
    assert (sg[:, 0] > 0).any() and (sg[:, 1] > 0).any()
    # traced with the planner's entries and hints: the unplanned result
    _assert_same(_port(st, o, d), _port(st, o, d, hints=ph, start_g=sg))


@pytest.fixture(scope="module")
def unplanned(world):
    """The port's trace without entries, under each option."""
    tris, st, sj, o, d = world
    return {option: _port(st, o, d, **_options(st, len(o), option))
            for option in OPTIONS + REF_OPTIONS[1:]}


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_any_start_g_is_exact(world, unplanned, kind, option):
    tris, st, sj, o, d = world
    p = -(-len(o) // PACKET)
    kw = _options(st, len(o), option)
    sg = _entries(st, p, kind, seed=len(kind))
    got = _port(st, o, d, start_g=sg, **kw)
    _assert_same(unplanned[option], got)
    if kind == "random":
        # the same entries as a torch tensor, and JAX-made
        _assert_same(got, _port(st, o, d, start_g=torch.from_numpy(sg), **kw))
        _assert_same(got, _port(st, o, d, start_g=jnp.asarray(sg), **kw))


@pytest.mark.parametrize("option", REF_OPTIONS)
@pytest.mark.parametrize("kind", REF_KINDS)
def test_start_g_matches_reference(world, reference, unplanned, kind,
                                   option):
    tris, st, sj, o, d = world
    p = -(-len(o) // PACKET)
    sg = _entries(st, p, kind, seed=len(kind))
    got = _port(st, o, d, start_g=sg, **_options(st, len(o), option))
    _assert_same(unplanned[option], got)
    _assert_matches_reference(reference[option, kind], got)


@pytest.mark.parametrize("seed", [0, 1])
def test_start_g_on_a_chain_14_deep(world, seed):
    """Random and nested entries on a chain table 14 groups deep: the plain
    walk with them equals the plain walk without them."""
    (a, b, c), st, *_ = world
    chain = tb.chain_tables(st, 14)
    o, d = tb.aimed_rays(a, 2048, seed=seed)
    rows = _ray_rows(Ray.create(o, d, device=CPU),
                     torch.full((len(o),), np.inf))
    gn, grp = torch.from_numpy(chain.gnodes), torch.from_numpy(chain.groups)
    p = len(o) // 128
    rng = np.random.default_rng(seed)
    sg = rng.integers(-1, 14, (p, 2)).astype(np.int32)
    sg[::3, 1] = np.maximum(sg[::3, 0] - 3, 0)  # an ancestor second
    base = wide_mod.wide_trace_plain(gn, grp, rows, 16, packet=128)
    got = wide_mod.wide_trace_plain(gn, grp, rows, 16, packet=128,
                                    start_g=torch.from_numpy(sg))
    assert torch.equal(base[0].view(torch.int32), got[0].view(torch.int32))
    assert torch.equal(base[1], got[1]) and (got[1] >= 0).any()


def test_planned_entries_cut_group_tests(world):
    """On packets of 128 coherent rays (each around one cube), entering the
    planners' subtrees first cuts the group tests the packet's rays make
    (summed over the packets with an entry); the leaf fires stay."""
    (a, b, c), st, *_ = world
    o, d = _coherent(a, 2048)
    perm = sort_rays_device(o, d, mode="morton", device=CPU)[0]
    rays = Ray.create(o, d, device=CPU).take(perm)
    rows = _ray_rows(rays, torch.full((len(o),), np.inf))
    gn, grp = torch.from_numpy(st.gnodes), torch.from_numpy(st.groups)
    _, _, t0, f0 = wide_mod.wide_trace_plain(gn, grp, rows, W, packet=128,
                                             counts=True)
    for sg in (make_key_planner(st, packet=128, device=CPU)(rays.origin),
               make_planner(st, packet=128, device=CPU)(rays)[1]):
        on = sg[:, 0] > 0
        assert on.any()
        _, _, t1, f1 = wide_mod.wide_trace_plain(
            gn, grp, rows, W, packet=128, counts=True, start_g=sg)
        assert t1.view(-1, 128).sum(1)[on].sum() < t0.view(-1, 128).sum(1)[on].sum()
        assert torch.equal(f0, f1)


@pytest.mark.parametrize("wide", [True, False])
def test_seeded_trace_equals_unseeded(world, wide):
    tris, st, sj, o, d = world
    if not wide:
        st = build_tight_scene(*tris, wide=False)
        assert st.gnodes is None
    rays = Ray.create(o, d, device=CPU)
    got = trace_closest_hit_seeded(st, rays, tris=tris, packet=PACKET,
                                   device=CPU)
    want = trace_closest_hit_tight(st, rays, tris=tris, packet=PACKET,
                                   device=CPU)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    hints = compute_seed_hints(st, rays, packet=PACKET, device=CPU)
    assert hints.shape == (-(-len(o) // PACKET), 64) and (hints >= 0).any()
    assert compute_seed_hints(st, rays.take(torch.arange(8)), device=CPU) is None


@pytest.mark.parametrize("sweep", [False, True])
def test_make_tracer_key_plan_equals_per_call(world, sweep):
    tris, st, sj, o, d = world
    # unsorted input: the tracer sorts, then plans from the sorted origins
    shuffle = np.random.default_rng(9).permutation(len(o))
    o, d = o[shuffle], d[shuffle]
    planned = make_tracer(st, packet=PACKET, sweep=sweep, sort="morton",
                          tris=tris, plan="key", device=CPU)(o, d)
    plain = make_tracer(st, packet=PACKET, sweep=sweep, sort="morton",
                        tris=tris, device=CPU)(o, d)
    for x, y in zip(planned, plain):
        assert torch.equal(x, y)
    # the per-call path: the same sort, plan and trace, then un-permuted
    perm, inv = sort_rays_device(o, d, mode="morton", device=CPU)
    od = torch.cat([torch.from_numpy(o), torch.from_numpy(d)], 1)[perm]
    rays_s = Ray.create(od[:, 0:3], od[:, 3:6], device=CPU)
    sg = make_key_planner(st, packet=PACKET, device=CPU)(rays_s.origin)
    per_call = trace_closest_hit_tight(st, rays_s, tris=tris, packet=PACKET,
                                       sweep=sweep, start_g=sg, device=CPU)
    for x, y in zip(planned, per_call):
        assert torch.equal(x, y[inv])


def test_start_g_refusals(world):
    tris, st, sj, o, d = world
    rays = Ray.create(o, d, device=CPU)
    p = -(-len(o) // PACKET)
    gn = st.gnodes.shape[1]
    for scene, kw in ((st, {"wide": False}),
                      (build_tight_scene(*tris, packed=True), {}),
                      (st._replace(gnodes=None), {})):
        with pytest.raises(ValueError, match="start_g"):
            trace_closest_hit_tight(scene, rays, packet=PACKET, device=CPU,
                                    start_g=np.ones(p, np.int32), **kw)
    with pytest.raises(ValueError, match="Gn"):
        trace_closest_hit_tight(st, rays, packet=PACKET, device=CPU,
                                start_g=np.full(p, gn, np.int32))
    with pytest.raises(ValueError, match="start_g must be"):
        trace_closest_hit_tight(st, rays, packet=PACKET, device=CPU,
                                start_g=np.ones((p, 3), np.int32))
    with pytest.raises(ValueError, match="group walk"):
        make_key_planner(build_tight_scene(*tris, packed=True), device=CPU)
    rows = _ray_rows(rays, torch.full((len(o),), np.inf))
    with pytest.raises(ValueError, match="closest and bounded"):
        wide_mod.wide_trace(torch.from_numpy(wide_mod.group_records(st.gnodes)),
                            torch.from_numpy(st.groups), rows, W, st.gdepth,
                            packet=PACKET, mode="any",
                            start_g=torch.ones(p, 2, dtype=torch.int32))


def test_planners_need_cuda_unless_cpu(world, monkeypatch):
    """The planners, the seeders and the seeded trace run on the card
    unless the caller asks for the CPU."""
    tris, st, sj, o, d = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rays = Ray.create(o, d, device=CPU)
    for fn in (lambda: make_key_planner(st), lambda: make_planner(st),
               lambda: make_seeder(st),
               lambda: compute_seed_hints(st, rays),
               lambda: trace_closest_hit_seeded(st, rays)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    assert make_key_planner(st, device=CPU)(rays.origin).device == CPU
