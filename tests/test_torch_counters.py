"""The port's visit counters (``count_visits_tight``, ``count_visits_wide``,
``count_visits_nearest``) and the counting option of the kernel wrappers,
against the plain walks and against bvh_tpu's counters.

A packet's count in the port is the sum over its rays (points) of each
one's own walk's count (the docstrings); the reference counts one shared
cursor a packet. Tolerances:

* Against the plain walks' per-ray counts (``counts=True``) on the same
  rows: equal, summed by packet in the given order (a partial last packet
  included); the wrappers' ``t``/``d2`` and lanes equal those without
  counting, bit for bit. ``count_visits_nearest`` counts the walk as
  ``nearest_tight`` runs it, from the bound seed: the seed's group tests
  and the walk's steps on the seeded rows; per packet it fires at most the
  leaves the same walk fires unseeded.
* Against the reference (its reciprocal made exact), on packets whose
  rays (points) are all one ray (point), where the shared cursor walks
  what each lane walks (the port's nearest walks from unseeded rows, as
  the reference walks): exactly packet x the reference's count, for the
  entry/exit walk's node visits, the nearest walks' steps and every
  walk's leaf fires. The reference's group-walk iterations count the
  entered groups plus one pop per frame of its mask stack, and its group
  tests one masked test per iteration on top of the root's; on a
  two-level table (one frame, the root's) a ray's group tests in the port
  are then exactly the reference's iterations, and the reference's group
  tests are its iterations + 1.
* Against the reference on ordinary packets: every ray the reference's
  shared cursor takes into a node or a leaf also takes it in its own
  walk, under a bound at least as loose, so per packet the reference's
  node visits (entry/exit walk), group tests (group walk) and leaf fires
  are at most the port's.
* NaN boxes (the empty columns of a device build) never fire in any walk:
  over a delta part with no live triangle every ray tests the root alone
  and fires nothing, the sweep gate stays 0 and no point finds a
  triangle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bvh_tpu
from bvh_tpu.ops import cluster as cluster_j
from bvh_tpu.ops.nearest import count_visits_nearest as count_nearest_j
from bvh_tpu.ops.trace import count_visits_tight as count_tight_j
from bvh_tpu.ops.trace import count_visits_wide as count_wide_j
from bvh_tpu_torch import Ray
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import (build_tight_scene, count_visits_nearest,
                               count_visits_tight, count_visits_wide,
                               make_key_planner, make_updater,
                               nearest_entry_exit_plain, nearest_seed_plain,
                               nearest_tight, nearest_wide_plain,
                               tight_trace_plain,
                               wide_trace_plain)
from bvh_tpu_torch.ops import nearest as near_mod
from bvh_tpu_torch.ops import sweep as sweep_mod
from bvh_tpu_torch.ops import tight as tight_mod
from bvh_tpu_torch.ops import wide as wide_mod
from bvh_tpu_torch.ops.nearest import point_rows
from bvh_tpu_torch.ops.trace import _dev, _ray_rows, packet_sums
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
PACKET = 256


@pytest.fixture(scope="module")
def world():
    """create_n_cubes(200), 2,400 triangles (a wide table two levels deep);
    700 rays, reference-random and aimed (a partial last packet), and 600
    points near the cubes and far off."""
    a, b, c = tb.create_n_cubes(200)
    scene = build_tight_scene(a, b, c)
    o1, d1 = tb.create_rays(350, seed=tb.seed_state_after(3))
    o2, d2 = tb.aimed_rays(a, 350, seed=3)
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    rng = np.random.default_rng(4)
    cen = (a + b + c) / np.float32(3)
    pts = np.concatenate([
        cen[rng.integers(0, len(cen), 500)] + rng.normal(scale=5.0,
                                                         size=(500, 3)),
        rng.uniform(-1.2e5, 1.2e5, (100, 3))]).astype(np.float32)
    return (a, b, c), scene, o, d, pts


def _rows(o, d):
    rays = Ray.create(o, d, device=CPU)
    return _ray_rows(rays, torch.full((len(o),), float("inf")))


def test_packet_sums():
    x = torch.arange(10)
    assert packet_sums(x, 4).tolist() == [6, 22, 17]
    assert packet_sums(x, 4).dtype == torch.int64


@pytest.mark.parametrize("entries", [False, True])
def test_count_visits_wide_is_the_plain_walks_sum(world, entries):
    _, scene, o, d, _ = world
    rows = _rows(o, d)
    sg = None
    if entries:
        # the key planner's subtree entries, costed by the two-phase walk
        sg = make_key_planner(scene, packet=PACKET, device=CPU)(
            torch.from_numpy(o))
    gn, grp = torch.from_numpy(scene.gnodes), torch.from_numpy(scene.groups)
    t, lane, tests, fires = wide_trace_plain(gn, grp, rows, scene.width,
                                             packet=PACKET, counts=True,
                                             start_g=sg)
    it, fi, gt = count_visits_wide(scene, Ray.create(o, d, device=CPU),
                                   packet=PACKET, start_g=sg, device=CPU)
    p = -(-len(o) // PACKET)
    assert all(x.shape == (p,) and x.dtype == torch.int64
               for x in (it, fi, gt))
    assert torch.equal(gt, packet_sums(tests, PACKET))
    assert torch.equal(fi, packet_sums(fires, PACKET))
    assert torch.equal(it, gt + fi)
    assert int(fi.sum()) > 0 and (gt >= PACKET).all()
    # the wrapper's counting option: the same counts, the same results
    rec = _dev(scene.gnodes, CPU, wide_mod.group_records)
    out = wide_mod.wide_trace(rec, grp, rows, scene.width, scene.gdepth,
                              packet=PACKET, start_g=sg, counts=True)
    ref = wide_mod.wide_trace(rec, grp, rows, scene.width, scene.gdepth,
                              packet=PACKET, start_g=sg)
    assert torch.equal(out[0].view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(out[1], ref[1]) and torch.equal(out[1], lane)
    assert torch.equal(out[2], tests) and torch.equal(out[3], fires)


@pytest.mark.parametrize("packed", [False, True])
def test_count_visits_tight_is_the_plain_walks_sum(world, packed):
    """Packed scenes count through their packed table."""
    tris, scene, o, d, _ = world
    if packed:
        scene = build_tight_scene(*tris, packed=True)
    table = scene.packed_nodes if packed else scene.smem_nodes
    rows = _rows(o, d)
    grp = torch.from_numpy(scene.groups)
    _, lane, visits, fires = tight_trace_plain(
        torch.from_numpy(table), grp, rows, scene.width, packed=packed,
        packet=PACKET, counts=True)
    vi, fi = count_visits_tight(scene, Ray.create(o, d, device=CPU),
                                packet=PACKET, device=CPU)
    assert torch.equal(vi, packet_sums(visits, PACKET))
    assert torch.equal(fi, packet_sums(fires, PACKET))
    rec = _dev(table, CPU, sweep_mod.node_records)
    out = tight_mod.tight_trace(rec, grp, rows, scene.width, packed=packed,
                                packet=PACKET, counts=True)
    ref = tight_mod.tight_trace(rec, grp, rows, scene.width, packed=packed,
                                packet=PACKET)
    assert torch.equal(out[0].view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(out[1], ref[1]) and torch.equal(out[1], lane)
    assert torch.equal(out[2], visits) and torch.equal(out[3], fires)


@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_count_visits_nearest_is_the_plain_walks_sum(world, wide, masked):
    """Each point's own walk, in the given order (no sort), from the bound
    seed, whose group tests add to the steps; a masked scene (an updater's
    static part) walks without the bound refinement and without the
    seed."""
    tris, scene, _, _, pts = world
    if masked:
        upd = make_updater(scene, max_moved=16, device=CPU)
        scene = upd(*tris, np.arange(16, dtype=np.int32)).parts[0]
        assert scene.masked
    rows = point_rows(torch.from_numpy(pts), None)
    seed_tests = 0
    if not masked:
        seed_tests = nearest_seed_plain(torch.from_numpy(scene.gnodes), rows,
                                        counts=True)
        assert (seed_tests == scene.gdepth).any()
    grp = _dev(scene.groups, CPU)
    if wide:
        out = nearest_wide_plain(torch.from_numpy(scene.gnodes), grp, rows,
                                 scene.width, refine=not masked, counts=True)
    else:
        out = nearest_entry_exit_plain(torch.from_numpy(scene.smem_nodes),
                                       grp, rows, scene.width,
                                       refine=not masked, counts=True)
    st, fi = count_visits_nearest(scene, pts, packet=PACKET, wide=wide,
                                  device=CPU)
    assert st.shape == (-(-len(pts) // PACKET),)
    assert torch.equal(st, packet_sums(out[2] + seed_tests, PACKET))
    assert torch.equal(fi, packet_sums(out[3], PACKET))
    # the wrapper's counting option gives the same results as without
    table = (torch.from_numpy(scene.gnodes) if wide
             else torch.from_numpy(scene.smem_nodes))
    fn = near_mod.nearest_wide if wide else near_mod.nearest_entry_exit
    args = (scene.gdepth,) if wide else ()
    got = fn(table, grp, rows, scene.width, *args, refine=not masked,
             counts=True)
    plain = fn(table, grp, rows, scene.width, *args, refine=not masked)
    assert torch.equal(got[0].view(torch.int32), plain[0].view(torch.int32))
    assert torch.equal(got[1], plain[1])
    assert torch.equal(got[2], out[2]) and torch.equal(got[3], out[3])
    if not masked:
        # the default walk is the group walk where the scene has gnodes
        if wide:
            assert torch.equal(count_visits_nearest(scene, pts, packet=PACKET,
                                                    device=CPU)[0], st)
        # without the refinement (the same scene, masked) the walk takes at
        # least as many steps
        sm = make_updater(scene, max_moved=1, device=CPU)(
            *tris, np.full(1, -1, np.int32)).parts[0]
        st_m, _ = count_visits_nearest(sm, pts, packet=PACKET, wide=wide,
                                       device=CPU)
        assert (st_m >= st).all()


def test_counters_reject(world):
    tris, scene, o, d, pts = world
    rays = Ray.create(o, d, device=CPU)
    with pytest.raises(ValueError, match="not ported"):
        count_visits_wide(scene, rays, exp="fr", device=CPU)
    packed = build_tight_scene(*tris, packed=True)
    with pytest.raises(ValueError):
        count_visits_wide(packed, rays, device=CPU)
    with pytest.raises(ValueError):
        count_visits_nearest(packed, pts, device=CPU)
    with pytest.raises(ValueError):
        count_visits_tight(scene, rays, packet=100, device=CPU)
    empty = Ray.create(o[:0], d[:0], device=CPU)
    assert count_visits_tight(scene, empty, device=CPU)[0].shape == (0,)
    assert all(x.shape == (0,) for x in count_visits_wide(scene, empty,
                                                          device=CPU))
    assert count_visits_nearest(scene, pts[:0], device=CPU)[1].shape == (0,)


@pytest.fixture
def exact_reciprocal(monkeypatch):
    jax.clear_caches()
    monkeypatch.setattr(pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def test_counts_bound_the_references(exact_reciprocal):
    """Per packet the reference's shared-cursor counts are at most the sums
    of the port's per-ray counts (see the module notes), on equal tables
    and rays."""
    a, b, c = tb.create_n_cubes(60)
    sj = cluster_j.build_tight_scene(a, b, c)
    st = build_tight_scene(a, b, c)
    o, d = tb.aimed_rays(a, 512, seed=6)
    rj = bvh_tpu.Ray.create(jnp.asarray(o), jnp.asarray(d))
    rt = Ray.create(o, d, device=CPU)
    _, f_wj, g_wj = count_wide_j(sj, rj, packet=PACKET, interpret=True)
    _, f_w, g_w = count_visits_wide(st, rt, packet=PACKET, device=CPU)
    v_tj, f_tj = count_tight_j(sj, rj, packet=PACKET, interpret=True)
    v_t, f_t = count_visits_tight(st, rt, packet=PACKET, device=CPU)
    for ref, port in ((g_wj, g_w), (f_wj, f_w), (v_tj, v_t), (f_tj, f_t)):
        ref = np.asarray(ref)
        assert ref.shape == tuple(port.shape) and (ref > 0).all()
        assert (ref <= port.numpy()).all()


@pytest.mark.parametrize("walk", ["wide", "tight", "nearest_wide",
                                  "nearest_tight"])
def test_counts_equal_the_references_on_uniform_packets(walk,
                                                        exact_reciprocal):
    """Packets of one ray (point) repeated: the port's sums are exactly
    packet x the reference's counts (see the module notes)."""
    a, b, c = tb.create_n_cubes(60)
    sj = cluster_j.build_tight_scene(a, b, c)
    st = build_tight_scene(a, b, c)
    assert st.gdepth == 2
    if walk.startswith("nearest"):
        rng = np.random.default_rng(4)
        cen = (a + b + c) / np.float32(3)
        x = np.concatenate([
            cen[rng.integers(0, len(cen), 6)] + rng.normal(scale=5.0,
                                                           size=(6, 3)),
            rng.uniform(-1.2e5, 1.2e5, (2, 3))]).astype(np.float32)
        pts = np.repeat(x, PACKET, axis=0)
        wide = walk == "nearest_wide"
        ref = count_nearest_j(sj, pts, packet=PACKET, interpret=True,
                              wide=wide)
        # the reference walks unseeded: the port's walk on unseeded rows
        rows = point_rows(torch.from_numpy(pts), None)
        grp = _dev(st.groups, CPU)
        if wide:
            out = near_mod.nearest_wide(_dev(st.gnodes, CPU), grp, rows,
                                        st.width, st.gdepth, counts=True)
        else:
            out = near_mod.nearest_entry_exit(_dev(st.smem_nodes, CPU), grp,
                                              rows, st.width, counts=True)
        port = [packet_sums(x, PACKET) for x in out[2:]]
        pairs = list(zip(ref, port))
    else:
        o1, d1 = tb.aimed_rays(a, 8, seed=6)
        o2, d2 = tb.create_rays(4, seed=tb.seed_state_after(3))
        o = np.repeat(np.concatenate([o1, o2]), PACKET, axis=0)
        d = np.repeat(np.concatenate([d1, d2]), PACKET, axis=0)
        rj = bvh_tpu.Ray.create(jnp.asarray(o), jnp.asarray(d))
        rt = Ray.create(o, d, device=CPU)
        if walk == "wide":
            it_j, f_j, g_j = (np.asarray(x) for x in count_wide_j(
                sj, rj, packet=PACKET, interpret=True))
            _, f_p, g_p = count_visits_wide(st, rt, packet=PACKET,
                                            device=CPU)
            assert np.array_equal(g_j, it_j + 1)
            pairs = [(it_j, g_p), (f_j, f_p)]
        else:
            pairs = list(zip(count_tight_j(sj, rj, packet=PACKET,
                                           interpret=True),
                             count_visits_tight(st, rt, packet=PACKET,
                                                device=CPU)))
    for ref, got in pairs:
        ref = np.asarray(ref)
        assert ref.shape == tuple(got.shape) and (ref > 0).all()
        assert np.array_equal(PACKET * ref, got.numpy())


@pytest.mark.parametrize("wide", [True, False])
def test_count_visits_nearest_fires_at_most_unseeded(world, wide):
    """``count_visits_nearest`` counts the seeded walk: per packet it fires
    at most the leaves the same walk fires from unseeded rows."""
    _, scene, _, _, pts = world
    rows = point_rows(torch.from_numpy(pts), None)
    grp = _dev(scene.groups, CPU)
    if wide:
        *_, fires = nearest_wide_plain(torch.from_numpy(scene.gnodes), grp,
                                       rows, scene.width, counts=True)
    else:
        *_, fires = nearest_entry_exit_plain(
            torch.from_numpy(scene.smem_nodes), grp, rows, scene.width,
            counts=True)
    _, fi = count_visits_nearest(scene, pts, packet=PACKET, wide=wide,
                                 device=CPU)
    unseeded = packet_sums(fires, PACKET)
    assert (fi <= unseeded).all() and (fi < unseeded).any()


def test_nan_boxes_never_fire():
    """A delta part with no live triangle (every column a NaN box): the
    group walk and the entry/exit walk test the root alone and fire
    nothing, the sweep gate and the part's root gate stay 0, and neither
    nearest walk finds a triangle (plain versions: the kernels are held
    against them on the card)."""
    a, b, c = tb.create_n_cubes(20)
    scene = build_tight_scene(a, b, c)
    ch = make_updater(scene, max_moved=300, device=CPU)(
        a, b, c, np.full(300, -1, np.int32))
    delta = ch.parts[1]
    assert torch.isnan(delta.smem_nodes[:6]).all()
    o, d = tb.aimed_rays(a, 300, seed=1)
    rays = Ray.create(o, d, device=CPU)
    it, fi, gt = count_visits_wide(delta, rays, packet=PACKET, device=CPU)
    assert gt.tolist() == [256, 44] and fi.sum() == 0
    vi, fi = count_visits_tight(delta, rays, packet=PACKET, device=CPU)
    assert vi.tolist() == [256, 44] and fi.sum() == 0
    rows = _rows(o, d)
    gate = sweep_mod.sweep_gate(_dev(delta.smem_nodes, CPU,
                                     sweep_mod.node_records), rows, PACKET)
    assert gate.tolist() == [0, 0]
    for wide in (True, False):
        st, fn = count_visits_nearest(delta, o, packet=PACKET, wide=wide,
                                      device=CPU)
        assert fn.sum() == 0
        sid, dist = nearest_tight(delta, o, wide=wide, device=CPU)
        assert (sid == -1).all() and torch.isinf(dist).all()
