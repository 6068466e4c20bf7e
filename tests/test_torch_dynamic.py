"""The port's dynamic scenes against bvh_tpu on the same seeded inputs: the
LBVH build, the flat refit, the device scene builds, the refitter and the
mask+delta updaters (``bvh_tpu_torch/bvh/lbvh.py``, ``bvh/refit.py``,
``ops/device_build.py``, ``ops/update.py``).

Tolerances:

* Tables: array-equal to the reference's (dtype, shape and every value,
  NaN boxes in place), ids included.
* Traces (``check_trace``): where the port and brute force over the
  (moved) triangles both hit, |t - t_brute| <= 2e-5 t plus 4 ulps of the
  largest coordinate of the origin or the hit point (brute force works in
  world coordinates up to 1.2e5, where an ulp is 0.0078). Against the
  reference's trace over its equal tables, with its reciprocal made exact
  for the module (``exact_recip``): where the ids agree, t within one key
  step (W ulps) and off on at most 1% of the hits; ids differ on at most
  1% of the hits (at least 8 allowed), each with t within
  ``GRAZING_RTOL`` (the near-tie and grazing-edge classes,
  ``test_torch_chained.assert_tie_class``). Any hit: equal to brute
  force outside rays whose hit lies within ``GRAZING_RTOL`` of t_max.
* Hit masks: a ray on which the port, brute force and the reference do
  not all agree must be of the edge class (``assert_edge_class``): each
  of them that hits puts its hit point within 2^-20 of its distance from
  the world origin (8 ulps; 0.1 of a unit at 1e5) of an edge of the
  triangle it hit, where float32 cannot tell the two triangles of the
  edge apart, and at most max(2, 1%) of the rays are such. Two are seen:
  ray 140 of the growth test (t = 104,439: the reference, float64 and the
  port hit triangle 11, 0.039 of a unit from its edge, float32 brute
  force 10 at 0.0073; the port missed both before host builds carried
  ``a_lo``, ROADMAP queue 3 item 9, and the test now holds it to the
  float64 oracle) and ray 281 of the giant-churn test (the port and the
  reference hit triangle 34 at 0.037 from its edge, brute force misses).

The reference's traces run at one packet (512) without the sweep (which
changes no result), so that its compiled interpret-mode kernels serve
several tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bvh_tpu
from bvh_tpu.bvh import build_sah as build_sah_j
from bvh_tpu.bvh.lbvh import build_lbvh as build_lbvh_j
from bvh_tpu.bvh.refit import refit as refit_j
from bvh_tpu.bvh.refit import update_shapes as update_shapes_j
from bvh_tpu.ops import cluster as cluster_j
from bvh_tpu.ops import device_build as db_j
from bvh_tpu.ops import update as upd_j
from bvh_tpu.ops.trace import count_visits_tight as count_tight_j
from bvh_tpu.ops.trace import trace_any_hit_chained as any_chained_j
from bvh_tpu.ops.trace import trace_closest_hit_chained as closest_chained_j
from bvh_tpu.ops.trace import trace_closest_hit_tight as closest_tight_j
from bvh_tpu_torch import Ray, ray_intersects_triangle
from bvh_tpu_torch import point_triangle_distance_squared as point_d2
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.bvh import build_lbvh, build_sah, refit, update_shapes
from bvh_tpu_torch.bvh.lbvh import clz32
from bvh_tpu_torch.ops import (build_chained_scene, build_chained_scene_device,
                               build_tight_scene, build_tight_scene_device,
                               count_visits_nearest, count_visits_tight,
                               make_chained_updater, make_refitter,
                               make_updater, nearest_chained, nearest_tight,
                               nearest_seed_plain, nearest_wide_plain,
                               trace_any_hit_chained,
                               trace_closest_hit_chained,
                               trace_closest_hit_tight)
from bvh_tpu_torch.ops import trace as trace_mod
from bvh_tpu_torch.ops import update as upd_t
from test_torch_chained import GRAZING_RTOL, assert_tie_class
from test_torch_scene import exact_a_lo
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
PACKET = 512  # the reference's traces, all at one packet and 512 rays


@pytest.fixture(scope="module")
def exact_recip():
    """The reference's approximate reciprocal (bfloat16 in interpret mode)
    made exact for the module; compiled traces dropped before and after."""
    jax.clear_caches()
    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    mp.undo()
    jax.clear_caches()


def _same(h1, h2) -> bool:
    """Two HitRecords' t bit for bit and their ids equal."""
    return (torch.equal(h1.t.view(torch.int32), h2.t.view(torch.int32))
            and torch.equal(h1.shape_id, h2.shape_id))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_scene_equal(sj, st):
    """Every field of the reference's TightScene equal in the port's
    (arrays: dtype, shape, values with NaN in place); the port's own
    ``a_lo`` is held by ``test_a_lo_is_the_exact_remainder``."""
    assert st._fields == sj._fields + ("a_lo",)
    for name in sj._fields:
        x, y = getattr(sj, name), getattr(st, name)
        if x is None or y is None:
            assert x is None and y is None, name
        elif isinstance(y, (bool, int)):
            assert y == x, name
        else:
            x, y = np.asarray(x), _np(y)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert np.array_equal(x, y, equal_nan=True), name


def assert_chain_equal(cj, ct):
    assert len(cj.parts) == len(ct.parts) == len(ct.orig_ids)
    for pj, pt in zip(cj.parts, ct.parts):
        assert_scene_equal(pj, pt)
    for ij, it in zip(cj.orig_ids, ct.orig_ids):
        assert np.array_equal(np.asarray(ij), _np(it))
        assert _np(it).dtype == np.int32


def _flat_equal(fj, ft):
    for x, y in zip(fj.to_host(), ft.to_host()):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _aimed(a, b, c, n, seed, spread=60.0):
    """Rays from the box [-spread, spread]³ aimed at triangle centroids (the
    reference's update tests)."""
    rng = np.random.default_rng(seed)
    centers = (a + b + c) / np.float32(3)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = (centers[rng.integers(0, len(a), n)] - o).astype(np.float32)
    return o, d


def check_trace(ht, o, d, tris, hj=None, W: int = 16):
    """``ht`` (the port's HitRecord) against brute force over ``tris`` and,
    given ``hj``, against the reference's (see the module notes)."""
    bt, bs = _brute(o, d, *tris)
    t_g, s_g = ht.t.numpy(), ht.shape_id.numpy()
    hit, bf = np.isfinite(t_g), np.isfinite(bt)
    both = hit & bf
    p = o + bt[:, None] * _unit(d)
    scale = np.maximum(np.abs(o).max(axis=1),
                       np.abs(np.where(both[:, None], p, 0.0)).max(axis=1))
    err = np.abs(t_g[both].astype(np.float64) - bt[both])
    assert (err <= 2e-5 * bt[both] + 4 * 2.0 ** -23 * scale[both]).all()
    hits = [(t_g, s_g), (bt, bs)]
    off = hit != bf
    if hj is not None:
        t_r, s_r = np.asarray(hj.t), np.asarray(hj.shape_id)
        hits.append((t_r, s_r))
        off |= np.isfinite(t_r) != hit
    assert_edge_class(np.nonzero(off)[0], o, d, tris, hits)
    if hj is not None:
        keep = ~off
        assert_tie_class((t_r[keep], s_r[keep]), (t_g[keep], s_g[keep]), W)


def _unit(d):
    d = d.astype(np.float64)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def assert_edge_class(idx, o, d, tris, hits):
    """Rays ``idx`` (at most max(2, 1%) of them) are of the edge class:
    every (t, shape_id) of ``hits`` that hits one of them puts its hit
    point within 2^-20 of the point's distance from the world origin of
    an edge of the triangle it names (see the module notes)."""
    assert len(idx) <= max(2, len(o) // 100)
    for i in idx:
        for t, s in hits:
            if not np.isfinite(t[i]):
                continue
            p = o[i] + np.float64(t[i]) * _unit(d[i])
            v = [x[s[i]].astype(np.float64) for x in tris]
            dist = min(_segment_distance(p, v[k], v[(k + 1) % 3])
                       for k in range(3))
            assert dist <= 2.0 ** -20 * np.linalg.norm(p), (i, s[i], dist)


def _segment_distance(p, u, v):
    e = v - u
    s = np.clip(np.dot(p - u, e) / np.dot(e, e), 0.0, 1.0)
    return np.linalg.norm(p - (u + s * e))


def _brute(o, d, a, b, c):
    rays = Ray.create(o, d, device=CPU)
    t = ray_intersects_triangle(Ray(*(x[:, None] for x in rays)),
                                *(torch.from_numpy(x)[None] for x in (a, b, c))
                                ).distance
    best = t.amin(dim=1).numpy()
    return best, np.where(np.isfinite(best), t.argmin(dim=1).numpy(), -1)


# ---- LBVH, flat refit ---------------------------------------------------------

def test_clz32():
    v = np.array([0, 1, 2, 3, 255, 256, 65535, 65536, 1 << 29, (1 << 30) - 1,
                  1 << 30, 0x7FFFFFFF], np.int64)
    want = [32 - int(x).bit_length() for x in v]
    assert clz32(torch.from_numpy(v).to(torch.int32)).tolist() == want


@pytest.mark.parametrize("n_cubes", [1, 2, 5, 64, 333])
def test_build_lbvh_equal(n_cubes):
    a, b, c = tb.create_n_cubes(n_cubes)
    mn, mx = tb.tri_aabbs(a, b, c)
    fj, sj = build_lbvh_j(jnp.asarray(mn), jnp.asarray(mx))
    ft, st = build_lbvh(torch.from_numpy(mn), torch.from_numpy(mx))
    _flat_equal(fj, ft)
    assert np.array_equal(np.asarray(sj), st.numpy())
    assert ft.num_nodes == 2 * mn.shape[0] - 1


def test_build_lbvh_duplicate_centroids():
    """Equal Morton codes take the index tie-break (clz of i ^ j)."""
    mn = np.zeros((37, 3), np.float32)
    mx = np.ones((37, 3), np.float32)
    fj, _ = build_lbvh_j(jnp.asarray(mn), jnp.asarray(mx))
    ft, _ = build_lbvh(torch.from_numpy(mn), torch.from_numpy(mx))
    _flat_equal(fj, ft)


@pytest.mark.parametrize("fn", ["refit", "update_shapes"])
def test_refit_equal(fn):
    """A flat refit after moving half the shapes: the reference's boxes bit
    for bit, the topology unchanged, every box the join of its children."""
    a, b, c = tb.create_n_cubes(50)
    a2, b2, c2, _ = tb.randomly_transform_scene(a, b, c, len(a) // 2, seed=99)
    mn, mx = tb.tri_aabbs(a, b, c)
    mn2, mx2 = tb.tri_aabbs(a2, b2, c2)
    f_j = {"refit": refit_j, "update_shapes": update_shapes_j}[fn]
    f_t = {"refit": refit, "update_shapes": update_shapes}[fn]
    want = f_j(build_sah_j(mn, mx)[0].to_device(), jnp.asarray(mn2),
               jnp.asarray(mx2))
    flat, _ = build_sah(mn, mx)
    got = f_t(flat.to_device(device=CPU), torch.from_numpy(mn2),
              torch.from_numpy(mx2))
    _flat_equal(want, got)
    h = got.to_host()
    assert np.array_equal(h.entry, flat.entry)
    for i in np.nonzero(h.entry >= 0)[0]:
        left, right = i + 1, h.exit[i + 1]
        assert np.array_equal(h.aabb_min[i], np.minimum(h.aabb_min[left],
                                                        h.aabb_min[right]))
        assert np.array_equal(h.aabb_max[i], np.maximum(h.aabb_max[left],
                                                        h.aabb_max[right]))


def test_flat_to_device_to_host():
    a, b, c = tb.create_n_cubes(5)
    flat, _ = build_sah(*tb.tri_aabbs(a, b, c))
    dev = flat.to_device(dtype=torch.float64, device=CPU)
    assert all(torch.is_tensor(x) for x in dev)
    assert dev.aabb_min.dtype == torch.float64
    assert dev.entry.dtype == torch.int32
    back = flat.to_device(device=CPU).to_host()
    for x, y in zip(flat, back):
        assert x.dtype == y.dtype and np.array_equal(x, y)


# ---- device builds --------------------------------------------------------------

@pytest.mark.parametrize("case", ["grid", "lbvh", "bmat", "width32",
                                  "not_multiple_of_16", "one_cluster"])
def test_build_tight_scene_device_equal(case):
    a, b, c = tb.create_n_cubes(1 if case == "one_cluster" else 40)
    if case == "not_multiple_of_16":
        a, b, c = tb.create_n_cubes(3)
        a, b, c = a[:29], b[:29], c[:29]
    kw = {"lbvh": {"upper": "lbvh"}, "bmat": {"bmat": True},
          "width32": {"width": 32}}.get(case, {})
    sj = db_j.build_tight_scene_device(a, b, c, **kw)
    st = build_tight_scene_device(a, b, c, device=CPU, **kw)
    assert_scene_equal(sj, st)
    assert (st.gnodes is not None) == (case not in ("lbvh", "bmat"))
    assert all(torch.is_tensor(x) for x in (st.smem_nodes, st.groups,
                                            st.tri_map))
    ids = st.tri_map[st.tri_map >= 0].sort().values
    assert torch.equal(ids, torch.arange(a.shape[0], dtype=torch.int32))


def _near_aimed(a, n, seed, dist=40.0, aim=0.19):
    """The reference's device-build test rays: from ``dist`` units off each
    cube's centre in a random direction, aimed ``aim`` past it."""
    centers = a.reshape(-1, 12, 3).mean(axis=1)
    rng = np.random.default_rng(seed)
    idx = np.resize(np.arange(len(centers)), n)
    offs = rng.normal(size=(n, 3)).astype(np.float32)
    offs /= np.linalg.norm(offs, axis=1, keepdims=True)
    o = (centers[idx] + offs * dist).astype(np.float32)
    return o, (centers[idx] + aim - o).astype(np.float32)


@pytest.mark.parametrize("upper", ["grid", "lbvh"])
def test_device_scene_traces(upper, exact_recip):
    """The reference's device-build rays (a quarter turned away) through
    the device-built scene: brute force, the reference's walk on the same
    tables (grid), and the group walk equal to the entry/exit walk.

    The scene's walks test leaves in the exact cluster frame (``a_lo``),
    the reference in its rounded far frame, whose raw t lies up to a few
    hundred ulps off on these rays; so the reference is held against the
    port's walk over the same tables without ``a_lo`` (its own frame), and
    the exact-frame walk against brute force."""
    a, b, c = tb.create_n_cubes(40)
    st = build_tight_scene_device(a, b, c, upper=upper, device=CPU)
    o, d = _near_aimed(a, 512, seed=17)
    d[::4] = -d[::4]
    rays = Ray.create(o, d, device=CPU)
    ht = trace_closest_hit_tight(st, rays, packet=256, device=CPU)
    check_trace(ht, o, d, (a, b, c), W=st.width)
    if upper == "grid":
        sj = db_j.build_tight_scene_device(a, b, c, upper=upper)
        hj = closest_tight_j(sj, bvh_tpu.Ray.create(o, d), packet=PACKET,
                             interpret=True)
        assert _same(trace_closest_hit_tight(st, rays, packet=256,
                                             wide=False, device=CPU), ht)
        h_rounded = trace_closest_hit_tight(st._replace(a_lo=None), rays,
                                            packet=256, device=CPU)
        check_trace(h_rounded, o, d, (a, b, c), hj, st.width)


def test_build_chained_scene_device_equal():
    a, b, c = tb.create_n_cubes(120)  # 1,440 triangles in 3 parts
    cj = db_j.build_chained_scene_device(a, b, c, max_part=500)
    ct = build_chained_scene_device(a, b, c, max_part=500, device=CPU)
    assert len(ct.parts) == 3
    assert_chain_equal(cj, ct)
    assert len({tuple(p.smem_nodes.shape) for p in ct.parts}) == 1
    o, d = _near_aimed(a, 384, seed=11, dist=35.0, aim=0.21)
    ht = trace_closest_hit_chained(ct, Ray.create(o, d, device=CPU),
                                   packet=128, device=CPU)
    check_trace(ht, o, d, (a, b, c))
    assert np.isfinite(ht.t.numpy()).mean() > 0.9


def test_build_chained_scene_device_single_part():
    a, b, c = tb.create_n_cubes(10)
    cj = db_j.build_chained_scene_device(a, b, c, max_part=10_000)
    ct = build_chained_scene_device(a, b, c, max_part=10_000, device=CPU)
    assert len(ct.parts) == 1
    assert_chain_equal(cj, ct)
    assert torch.equal(ct.orig_ids[0], torch.arange(120, dtype=torch.int32))


# ---- refitter -------------------------------------------------------------------

def _deformed(a, b, c, seed=5):
    """The reference's refitter test: y squashed, x shifted, a wobble per
    triangle."""
    rng = np.random.default_rng(seed)
    wob = rng.normal(scale=0.2, size=(a.shape[0], 1, 3)).astype(np.float32)
    pts = np.stack([a, b, c], axis=1) * np.float32([1.0, 0.6, 1.0]) + wob
    pts[:, :, 0] += 7.0
    return pts[:, 0], pts[:, 1], pts[:, 2]


@pytest.mark.parametrize("case", ["identity", "deformed", "bmat_deformed",
                                  "packed_sweep_deformed"])
def test_refitter_equal(case):
    a, b, c = tb.create_n_cubes(30)
    kw = {"bmat_deformed": {"bmat": True},
          "packed_sweep_deformed": {"packed": True, "sweep_cut": 4}}.get(case,
                                                                          {})
    sj = cluster_j.build_tight_scene(a, b, c, use_native=False, **kw)
    st = build_tight_scene(a, b, c, use_native=False, **kw)
    verts = (a, b, c) if case == "identity" else _deformed(a, b, c)
    rj = db_j.make_refitter(sj)(*verts)
    rt = make_refitter(st, device=CPU)(*verts)
    assert_scene_equal(rj, rt)
    assert rt.sweep_nodes is None and rt.packed_nodes is None
    if case == "identity":
        assert np.array_equal(rt.gnodes.numpy(), st.gnodes, equal_nan=True)
        np.testing.assert_allclose(rt.smem_nodes.numpy(), st.smem_nodes,
                                   atol=1e-5)


def test_refit_scene_traces():
    """The refit scene after moving a third of the triangles, against brute
    force on rays aimed at the moved scene's centroids; its refit
    group-walk table gives the entry/exit walk's results."""
    a, b, c = tb.create_n_cubes(40)
    a2, b2, c2, _ = tb.randomly_transform_scene(a, b, c, len(a) // 3, seed=11)
    rt = make_refitter(build_tight_scene(a, b, c, use_native=False),
                       device=CPU)(a2, b2, c2)
    o, d = _aimed(a2, b2, c2, 512, seed=3)
    rays = Ray.create(o, d, device=CPU)
    ht = trace_closest_hit_tight(rt, rays, packet=256, device=CPU)
    check_trace(ht, o, d, (a2, b2, c2))
    assert torch.isfinite(ht.t).float().mean() > 0.5
    assert _same(trace_closest_hit_tight(rt, rays, packet=256, wide=False,
                                         device=CPU), ht)


# ---- mask + delta updates ---------------------------------------------------------

@pytest.fixture(scope="module")
def moved():
    """The reference's update fixture: create_n_cubes(100), 1,200
    triangles, three whole cubes moved by 20-60 units."""
    rng = np.random.default_rng(23)
    a, b, c = tb.create_n_cubes(100)
    sj = cluster_j.build_tight_scene(a, b, c)
    st = build_tight_scene(a, b, c)
    cubes = rng.choice(100, size=3, replace=False)
    ids = np.concatenate([np.arange(12) + 12 * k for k in cubes]).astype(
        np.int32)
    shift = rng.uniform(20, 60, size=(3,)).astype(np.float32)
    a2, b2, c2 = a.copy(), b.copy(), c.copy()
    for arr in (a2, b2, c2):
        arr[ids] += shift
    return (a, b, c), sj, st, ids, (a2, b2, c2)


def _padded(ids, cap):
    pad = np.full(cap, -1, np.int32)
    pad[:len(ids)] = ids
    return pad


def test_updater_equal(moved):
    _, sj, st, ids, new = moved
    pad = _padded(ids, 64)
    cj = upd_j.make_updater(sj, max_moved=64)(*new, pad)
    ct = make_updater(st, max_moved=64, device=CPU)(*new, pad)
    assert_chain_equal(cj, ct)
    static = ct.parts[0]
    assert static.masked and static.bgroups is None
    # every box table is the scene's own; only the moved lanes are zeroed
    assert static.smem_nodes is st.smem_nodes and static.gnodes is st.gnodes
    g0 = st.groups.transpose(0, 2, 1).reshape(-1, 16)
    g1 = static.groups.numpy().transpose(0, 2, 1).reshape(-1, 16)
    lane = np.isin(st.tri_map, ids)
    assert (g1[lane] == 0).all() and np.array_equal(g1[~lane], g0[~lane])


@pytest.mark.parametrize("frame", ["cumulative_first", "all_moved"])
def test_updater_traces_as_reference(moved, frame, exact_recip):
    """Closest hit through the chained update (frame 1: the first cube
    only; frame 2: the cumulative set, against the ORIGINAL scene), against
    brute force over the moved triangles and the reference's trace; rays
    at the moved triangles' new places hit them there."""
    (a, b, c), sj, st, ids, new = moved
    if frame == "cumulative_first":
        ids = ids[:12]
        new = tuple(x.copy() for x in (a, b, c))
        for src, dst in zip(moved[4], new):
            dst[ids] = src[ids]
    pad = _padded(ids, 64)
    cj = upd_j.make_updater(sj, max_moved=64)(*new, pad)
    ct = make_updater(st, max_moved=64, device=CPU)(*new, pad)
    o, d = _aimed(*new, 512, seed=7)
    hj = closest_chained_j(cj, bvh_tpu.Ray.create(o, d), packet=PACKET,
                           sweep=False, interpret=True)
    ht = trace_closest_hit_chained(ct, Ray.create(o, d, device=CPU),
                                   packet=256, device=CPU)
    check_trace(ht, o, d, new, hj)
    centers = ((new[0] + new[1] + new[2]) / np.float32(3))[ids]
    om = np.full((len(ids), 3), -80.0, np.float32)
    hm = trace_closest_hit_chained(ct, Ray.create(om, centers - om,
                                                  device=CPU),
                                   packet=128, device=CPU)
    check_trace(hm, om, centers - om, new)
    assert torch.isfinite(hm.t).all()


def test_updater_any_hit_as_reference(moved, exact_recip):
    _, sj, st, ids, new = moved
    pad = _padded(ids, 64)
    cj = upd_j.make_updater(sj, max_moved=64)(*new, pad)
    ct = make_updater(st, max_moved=64, device=CPU)(*new, pad)
    o, d = _aimed(*new, 512, seed=9)
    bt, bs = _brute(o, d, *new)
    tmx = np.where(np.isfinite(bt), bt * 1.25, 2.0).astype(np.float32)
    ref = np.asarray(any_chained_j(cj, bvh_tpu.Ray.create(o, d),
                                   t_max=jnp.asarray(tmx), packet=PACKET,
                                   sweep=False, interpret=True))
    got = trace_any_hit_chained(ct, Ray.create(o, d, device=CPU), t_max=tmx,
                                device=CPU).numpy()
    near = np.isfinite(bt) & (np.abs(tmx - bt) <= GRAZING_RTOL * tmx)
    assert np.array_equal(got[~near], (np.isfinite(bt) & (bt < tmx))[~near])
    off = np.nonzero((got != ref) & ~near)[0]
    assert np.isfinite(bt[off]).all()
    assert_edge_class(off, o, d, new, [(bt, bs)])
    assert got.any()


def test_updater_capacity_and_nearest(moved):
    """Too many ids raise; nearest over the update refines no bound from
    the masked static boxes and finds the moved triangles."""
    _, _, st, ids, new = moved
    upd = make_updater(st, max_moved=64, device=CPU)
    with pytest.raises(ValueError):
        upd(*new, np.zeros(100, np.int32))
    ch = upd(*new, _padded(ids, 64))
    pts = (((new[0] + new[1] + new[2]) / np.float32(3))[ids]
           + np.float32(0.01))
    sid, dist = nearest_chained(ch, pts, device=CPU)
    assert np.isin(sid.numpy(), ids).all()
    assert (dist.numpy() < 0.1).all()


def test_updater_partial_delta_skips_empty_capacity(moved, exact_recip):
    """A delta part filled far below its capacity holds NaN boxes in its
    empty columns, which never fire: with one live cube (one cluster) of a
    capacity of 360 (23 clusters), a ray fires at most the live cluster
    (the port's count_visits_tight), where inverted (+inf, -inf) boxes
    would open the empty capacity; the reference's own bound holds on its
    equal delta table."""
    _, sj, st, ids, new = moved
    mi = _padded(ids[:12], 360)
    cj = upd_j.make_updater(sj, max_moved=360)(*(jnp.asarray(x) for x in new),
                                                jnp.asarray(mi))
    ct = make_updater(st, max_moved=360, device=CPU)(*new, mi)
    delta_j, delta = cj.parts[1], ct.parts[1]
    assert_scene_equal(delta_j, delta)
    o, d = _aimed(*new, 2048, seed=8)
    rays = Ray.create(o, d, device=CPU)
    live = -(-12 // delta.width)
    vis, fires = count_visits_tight(delta, rays, packet=2048, device=CPU)
    assert fires.shape == (1,) and fires.dtype == torch.int64
    assert 0 < int(fires.sum()) <= live * 2048
    sn = delta.smem_nodes.clone()
    nan = torch.isnan(sn[0])
    sn[0:3, nan], sn[3:6, nan] = float("inf"), -float("inf")
    v_inv, f_inv = count_visits_tight(delta._replace(smem_nodes=sn), rays,
                                      packet=2048, device=CPU)
    assert int(v_inv.sum()) > int(vis.sum())
    assert int(f_inv.sum()) > int(fires.sum())
    _, fi_j = count_tight_j(delta_j, bvh_tpu.Ray.create(o, d), packet=2048,
                            interpret=True)
    assert fi_j.sum() / len(fi_j) <= 4 * live


def test_updater_empty_delta_gated_off(moved):
    """A delta with no live triangle has a NaN root box: its root gate
    closes every packet, and the update traces as the scene."""
    (a, b, c), _, st, _, _ = moved
    ch = make_updater(st, max_moved=64, device=CPU)(a, b, c,
                                                    np.full(64, -1, np.int32))
    o, d = _aimed(a, b, c, 256, seed=2)
    rays = Ray.create(o, d, device=CPU)
    rows = trace_mod._ray_rows(rays, torch.full((256,), float("inf")))
    root = ch.parts[1].smem_nodes[:6, 0]
    assert torch.isnan(root).all()
    gate = trace_mod._part_root_gate(rows, root, rows[6], 128)
    assert gate.tolist() == [0, 0]
    h1 = trace_closest_hit_chained(ch, rays, packet=128, device=CPU)
    assert _same(h1, trace_closest_hit_tight(st, rays, packet=128,
                                             device=CPU))


def test_updater_add_remove_growth(exact_recip):
    """Growth without a rebuild (the reference's test): new ids >= n enter
    the delta, alive=False entries are removed; the tables equal the
    reference's, the trace agrees with the reference's, brute force over
    the live triangles and a fresh build over them."""
    a, b, c = tb.create_n_cubes(60)  # 720 triangles
    n = a.shape[0]
    sj = cluster_j.build_tight_scene(a, b, c)
    st = build_tight_scene(a, b, c)
    na, nb, nc = (x[60 * 12:] + np.float32(7.0) for x in tb.create_n_cubes(62))
    removed = (np.arange(12) + 12 * 5).astype(np.int32)
    mv = (np.arange(12) + 12 * 17).astype(np.int32)
    ext = [np.concatenate([x, y]).astype(np.float32)
           for x, y in ((a, na), (b, nb), (c, nc))]
    for arr in ext:
        arr[mv] += np.float32(31.0)
    ids = np.concatenate([mv, removed, np.arange(n, n + 24, dtype=np.int32)])
    alive = np.concatenate([np.ones(12, bool), np.zeros(12, bool),
                            np.ones(24, bool)])
    uj = upd_j.make_updater(sj, max_moved=32, max_added=32)
    ut = make_updater(st, max_moved=32, max_added=32, device=CPU)
    assert ut.cap == uj.cap
    pad = ut.cap - ids.shape[0]
    ids = np.concatenate([ids, np.full(pad, -1, np.int32)])
    alive = np.concatenate([alive, np.zeros(pad, bool)])
    cj = uj(*ext, jnp.asarray(ids), jnp.asarray(alive))
    ct = ut(*ext, ids, alive)
    assert_chain_equal(cj, ct)
    live = np.ones(n + 24, bool)
    live[removed] = False
    live_tris = [x[live] for x in ext]
    o, d = _aimed(*live_tris, 512, seed=5)
    hj = closest_chained_j(cj, bvh_tpu.Ray.create(o, d), packet=PACKET,
                           sweep=False, interpret=True)
    rays = Ray.create(o, d, device=CPU)
    ht = trace_closest_hit_chained(ct, rays, packet=512, device=CPU)
    check_trace(ht, o, d, live_tris, hj)
    assert not np.isin(ht.shape_id.numpy(), removed).any()
    # ray 140 crosses the edge of triangles 10 and 11 of the host-built
    # static part ~1e5 from its origin: in the exact frame (the host
    # build's a_lo) it hits 11, as float64 and the reference do
    t64, s64 = _oracle64(o[140:141], d[140:141], *live_tris)
    t140 = np.float64(ht.t.numpy()[140])
    assert int(ht.shape_id[140]) == 11 == s64[0] == int(hj.shape_id[140])
    assert abs(t140 - t64[0]) <= 2e-4 * t64[0]
    fresh = trace_closest_hit_tight(build_tight_scene(*live_tris), rays,
                                    packet=512, device=CPU)
    assert torch.equal(torch.isfinite(fresh.t), torch.isfinite(ht.t))
    ctr = ((na + nb + nc) / np.float32(3)).astype(np.float32)
    o2 = ctr + np.float32(3.0)
    h2 = trace_closest_hit_chained(ct, Ray.create(o2, ctr - o2, device=CPU),
                                   packet=128, device=CPU)
    assert (h2.shape_id.numpy() >= n).any()


def test_updater_giant_churn_splits_delta(moved, monkeypatch, exact_recip):
    """A capacity beyond one delta table of the budget splits into D
    same-shape Morton-ordered parts (the budget made small on both
    packages' own modules)."""
    _, sj, st, ids, new = moved
    monkeypatch.setattr(upd_j, "_SMEM_BUDGET", 100)
    monkeypatch.setattr(upd_t, "_SMEM_BUDGET", 100)
    uj = upd_j.make_updater(sj, max_moved=64)
    ut = make_updater(st, max_moved=64, device=CPU)
    assert ut.delta_parts == uj.delta_parts > 1 and ut.cap == uj.cap
    pad = _padded(ids, ut.cap)
    cj, ct = uj(*new, pad), ut(*new, pad)
    assert len(ct.parts) == 1 + ut.delta_parts
    assert_chain_equal(cj, ct)
    o, d = _aimed(*new, 512, seed=41)
    hj = closest_chained_j(cj, bvh_tpu.Ray.create(o, d), packet=PACKET,
                           sweep=False, interpret=True)
    ht = trace_closest_hit_chained(ct, Ray.create(o, d, device=CPU),
                                   packet=256, device=CPU)
    check_trace(ht, o, d, new, hj)


def test_chained_updater_equal():
    rng = np.random.default_rng(31)
    a, b, c = tb.create_n_cubes(150)  # 1,800 triangles
    cj0 = cluster_j.build_chained_scene(a, b, c, max_part=700,
                                        use_native=False)
    ct0 = build_chained_scene(a, b, c, max_part=700, use_native=False)
    cubes = rng.choice(150, size=4, replace=False)
    mv = np.concatenate([np.arange(12) + 12 * k for k in cubes]).astype(
        np.int32)
    new = [x.copy() for x in (a, b, c)]
    for arr in new:
        arr[mv] += rng.uniform(15, 45, size=(3,)).astype(np.float32)
    pad = _padded(mv, 64)
    cj = upd_j.make_chained_updater(cj0, max_moved=64)(*new, pad)
    upd = make_chained_updater(ct0, max_moved=64, device=CPU)
    ct = upd(*new, pad)
    assert len(ct.parts) == 2 * len(ct0.parts)
    assert_chain_equal(cj, ct)
    with pytest.raises(ValueError):
        upd(*new, np.zeros(100, np.int32))
    o, d = _aimed(*new, 384, seed=3)
    ht = trace_closest_hit_chained(ct, Ray.create(o, d, device=CPU),
                                   packet=128, device=CPU)
    check_trace(ht, o, d, new)
    on_moved = np.isin(_brute(o, d, *new)[1], mv)
    assert on_moved.any()
    assert np.isin(ht.shape_id.numpy()[on_moved], mv).mean() > 0.9


def test_frame_stays_on_its_device(moved, monkeypatch):
    """Tensors in, tensors out: an update and its trace make no numpy copy
    of a tensor (every tensor-to-host path raises during the frame), the
    tables are tensors on the vertices' device, and a tensor table's
    layout is made once."""
    (a, b, c), _, st, ids, new = moved
    upd = make_updater(st, max_moved=64, device=CPU)
    refitter = make_refitter(st, device=CPU)
    verts = [torch.from_numpy(x) for x in new]
    moved_t = torch.from_numpy(_padded(ids, 64))
    o, d = _aimed(*new, 256, seed=1)
    rays = Ray.create(o, d, device=CPU)
    trace_closest_hit_chained(upd(*verts, moved_t), rays, device=CPU)

    def host_copy(*args, **kw):
        raise AssertionError("a frame copied a tensor to the host")

    for name in ("numpy", "tolist", "item", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, host_copy)
    ch = upd(*verts, moved_t)
    h = trace_closest_hit_chained(ch, rays, device=CPU)
    re = refitter(*verts)
    hr = trace_closest_hit_tight(re, rays, device=CPU)
    dev = build_tight_scene_device(*verts, device=CPU)
    hd = trace_closest_hit_tight(dev, rays, device=CPU)
    monkeypatch.undo()
    for sc in (ch.parts[1], re, dev):
        assert all(torch.is_tensor(x) and x.device == CPU
                   for x in (sc.smem_nodes, sc.groups, sc.gnodes))
    assert all(torch.is_tensor(i) for i in ch.orig_ids)
    for hit in (h, hr, hd):
        assert torch.isfinite(hit.t).any()
    rec = trace_mod._dev(dev.gnodes, CPU, trace_mod.group_records)
    assert trace_mod._dev(dev.gnodes, CPU, trace_mod.group_records) is rec
    assert trace_mod._dev(dev.smem_nodes, CPU) is dev.smem_nodes


# ---- the exact cluster frame of device-built, refit and delta scenes --------

def _oracle64(o, d, a, b, c):
    """Closest hit of each ray in float64 Moller-Trumbore with backface
    culling, over the float32-normalized directions the port's rays carry
    (``Ray.create``): ``(t, shape_id)``, +inf and -1 on a miss."""
    dn = Ray.create(o, d, device=CPU).direction.numpy().astype(np.float64)
    o = o.astype(np.float64)[:, None]
    a, b, c = (x.astype(np.float64)[None] for x in (a, b, c))
    e1, e2 = b - a, c - a
    p = np.cross(dn[:, None], e2)
    det = (e1 * p).sum(-1)
    s = o - a
    q = np.cross(s, e1)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = (s * p).sum(-1) / det
        v = (dn[:, None] * q).sum(-1) / det
        t = (e2 * q).sum(-1) / det
    ok = (det > 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
    t = np.where(ok, t, np.inf)
    best = t.min(axis=1)
    return best, np.where(np.isfinite(best), t.argmin(axis=1), -1)


@pytest.mark.parametrize("upper", ["grid", "lbvh"])
def test_far_frame_rays(upper, exact_recip):
    """A device build of create_n_cubes(40), whose Morton clusters span two
    cubes ~1e5 apart, traced with rays from [-60, 60]^3 aimed at its
    centroids (every fourth turned away): with the exact cluster frame
    (``a_lo``) the hit mask equals a float64 oracle's on every ray, with
    no edge-class allowance. Rays 7, 37 and 70, which the rounded frame
    missed, hit the oracle's triangles at brute force's t within 2e-4: 37
    and 70 brute force's triangles, 7 triangle 27, where float32 brute
    force takes triangle 35, which the float64 test misses by 6.7e-5 of
    its barycentric range. The reference's trace over its equal tables
    (its frame rounded) misses rays 37 and 197, which the port and the
    oracle hit; elsewhere its mask is the port's."""
    a, b, c = tb.create_n_cubes(40)
    st = build_tight_scene_device(a, b, c, upper=upper, device=CPU)
    assert st.a_lo is not None
    o, d = _aimed(a, b, c, 512, seed=17)
    d[::4] = -d[::4]
    rays = Ray.create(o, d, device=CPU)
    ht = trace_closest_hit_tight(st, rays, packet=256, device=CPU)
    if upper == "grid":
        assert _same(trace_closest_hit_tight(st, rays, packet=256,
                                             wide=False, device=CPU), ht)
    t, s = ht.t.numpy(), ht.shape_id.numpy()
    t64, s64 = _oracle64(o, d, a, b, c)
    assert np.array_equal(np.isfinite(t), np.isfinite(t64))
    bt, bs = _brute(o, d, a, b, c)
    for i in (7, 37, 70):
        assert np.isfinite(t[i]) and s[i] == s64[i], i
        assert abs(np.float64(t[i]) - bt[i]) <= 2e-4 * bt[i], i
    assert (s[37], s[70]) == (bs[37], bs[70]) and (s[7], bs[7]) == (27, 35)
    check_trace(ht, o, d, (a, b, c))
    rounded = trace_closest_hit_tight(st._replace(a_lo=None), rays,
                                      packet=256, device=CPU)
    assert not np.isfinite(rounded.t.numpy()[[7, 37, 70]]).any()
    if upper == "grid":
        sj = db_j.build_tight_scene_device(a, b, c)
        hj = closest_tight_j(sj, bvh_tpu.Ray.create(o, d), packet=PACKET,
                             interpret=True)
        hit_j = np.isfinite(np.asarray(hj.t))
        assert np.array_equal(np.nonzero(hit_j != np.isfinite(t))[0],
                              [37, 197])
        assert np.isfinite(t[[37, 197]]).all() and not hit_j[[37, 197]].any()


def _chunked(fn, o, d, tris, chunk: int = 512):
    """``fn(o, d, *tris)`` -> ``(t, shape_id)`` over ``chunk`` rays at a
    time."""
    out = [fn(o[s:s + chunk], d[s:s + chunk], *tris)
           for s in range(0, len(o), chunk)]
    return tuple(np.concatenate(x) for x in zip(*out))


@pytest.fixture(scope="module")
def edge_case(exact_recip):
    """The shared-edge case of the far frame: a device grid build of
    create_n_cubes(500) and 8,192 rays from [-60, 60]^3 aimed at its
    centroids (every fourth turned away; chip_smoke.py's far_aimed_rays,
    seed 17), with the float64 oracle, float32 brute force and the
    reference's trace over its equal tables."""
    a, b, c = tb.create_n_cubes(500)
    o, d = _aimed(a, b, c, 8192, seed=17)
    d[::4] = -d[::4]
    sj = db_j.build_tight_scene_device(a, b, c)
    hj = closest_tight_j(sj, bvh_tpu.Ray.create(o, d), packet=PACKET,
                         interpret=True)
    return {"tris": (a, b, c), "o": o, "d": d,
            "oracle": _chunked(_oracle64, o, d, (a, b, c)),
            "brute": _chunked(_brute, o, d, (a, b, c)),
            "reference": (np.asarray(hj.t), np.asarray(hj.shape_id))}


@pytest.mark.parametrize("upper, wide", [("grid", True), ("grid", False),
                                         ("lbvh", False)],
                         ids=["grid-group", "grid-entry_exit",
                              "lbvh-entry_exit"])
def test_far_frame_shared_edges(upper, wide, edge_case):
    """Where two triangles ~1e5 from the frame origin share an edge, the
    FRAME leaf test (tv and w = tv x d in float64) sees the ray at one
    place for both, so no seam opens: the hit mask equals the float64
    oracle's on all 8,192 rays. Rays 374, 2843 and 4003, which the
    float32 form missed (both walks), hit triangles 1365, 2960 and 468
    (the reference's) at the oracle's t within 2e-4. Ids that differ from
    the oracle's are of the edge class, and t is the oracle's within
    2e-5 (float32 brute force, which misses or hits 8 rays against the
    oracle, is no judge here). The reference's trace (its frame
    rounded) misses or hits rays 3178, 3989, 6263 and 7390 against the
    oracle, which sides with the port; elsewhere its mask is the
    port's. An LBVH build has no wide table, so it takes the entry/exit
    walk only."""
    ec = edge_case
    a, b, c = ec["tris"]
    o, d = ec["o"], ec["d"]
    st = build_tight_scene_device(a, b, c, upper=upper, device=CPU)
    ht = trace_closest_hit_tight(st, Ray.create(o, d, device=CPU),
                                 packet=256, wide=wide, device=CPU)
    t, s = ht.t.numpy(), ht.shape_id.numpy()
    t64, s64 = ec["oracle"]
    assert np.array_equal(np.isfinite(t), np.isfinite(t64))
    for i, want in ((374, 1365), (2843, 2960), (4003, 468)):
        assert s[i] == want == ec["reference"][1][i], i
        assert abs(np.float64(t[i]) - t64[i]) <= 2e-4 * t64[i], i
    off = np.nonzero(s != s64)[0]
    assert_edge_class(off, o, d, (a, b, c), [(t, s), (t64, s64)])
    hit_j = np.isfinite(ec["reference"][0])
    assert np.array_equal(np.nonzero(hit_j != np.isfinite(t))[0],
                          [3178, 3989, 6263, 7390])
    hit = np.isfinite(t)
    assert (np.abs(t[hit] - t64[hit]) <= 2e-5 * t64[hit]).all()


def _frame_parts(case):
    """(parts, lane -> triangle id per part, vertices) of a device build,
    an LBVH build, a device chain, a refit and an update's delta parts."""
    a, b, c = tb.create_n_cubes(40)
    if case in ("grid", "lbvh"):
        sc = build_tight_scene_device(a, b, c, upper=case, device=CPU)
        return [sc], [_np(sc.tri_map)], (a, b, c)
    if case == "chained":
        ch = build_chained_scene_device(a, b, c, max_part=160, device=CPU)
        ids = [_np(i)[_np(p.tri_map)] for p, i in zip(ch.parts, ch.orig_ids)]
        for x, p in zip(ids, ch.parts):
            x[_np(p.tri_map) < 0] = -1
        return list(ch.parts), ids, (a, b, c)
    a2, b2, c2, moved_ids = tb.randomly_transform_scene(a, b, c, len(a) // 3,
                                                        seed=11)
    scene = build_tight_scene(a, b, c, use_native=False)
    if case == "refit":
        rt = make_refitter(scene, device=CPU)(a2, b2, c2)
        return [rt], [_np(rt.tri_map)], (a2, b2, c2)
    ch = make_updater(scene, max_moved=len(moved_ids), device=CPU)(
        a2, b2, c2, moved_ids.astype(np.int32))
    # the static part keeps the host build's own table (masked lanes never
    # hit); the delta parts' tables are held below
    assert np.array_equal(_np(ch.parts[0].a_lo), scene.a_lo)
    parts, ids = [], []
    for p, i in zip(ch.parts[1:], ch.orig_ids[1:]):
        tm = _np(p.tri_map)
        ids.append(np.where(tm >= 0, _np(i)[np.maximum(tm, 0)], -1))
        parts.append(p)
    return parts, ids, (a2, b2, c2)


@pytest.mark.parametrize("case", ["grid", "lbvh", "chained", "refit", "delta"])
def test_a_lo_is_the_exact_remainder(case):
    """``a_lo`` of every lane is (a - cc) - a' computed in float64 and rounded
    once to float32, cc the frame origin the walks use (the cluster's leaf
    box centre in float32) and a' the stored row; 0 in pad lanes."""
    parts, ids, (a, b, c) = _frame_parts(case)
    for sc, tid in zip(parts, ids):
        got = _np(sc.a_lo)
        assert got.dtype == np.float32
        assert np.array_equal(got, exact_a_lo(sc, a, tid))
        if case in ("refit", "delta"):
            # moved triangles make a - cc inexact in float32
            assert np.abs(got).any()


# the near-tie class of a nearest query: triangles whose float64 squared
# distance lies within 2^-20 (8 float32 ulps) of the least
NEAR_TIE_RTOL = 2.0 ** -20


@pytest.mark.parametrize("wide", [True, False])
def test_nearest_far_frame(wide):
    """Both nearest walks on a device grid build of create_n_cubes(40)
    (frame origins up to ~1e5 from their triangles), points within a few
    units of the cubes: every reported triangle's float64 squared distance
    is the least over all triangles in float64 outside the near-tie class
    (within ``NEAR_TIE_RTOL`` of it), and the reported distance is brute
    force's at the port's nearest bound |dist - bd| <= 1e-5 bd + 1e-2. The
    walks test leaves in the exact cluster frame (``a_lo``, the FRAME
    builds on the card); without it they round p - cc in the far frame,
    and point 326 takes triangle 302 at d^2 = 1.35375 for 307 at 1.35277
    (a measurement of the rounded frame, never a path)."""
    a, b, c = tb.create_n_cubes(40)
    st = build_tight_scene_device(a, b, c, device=CPU)
    assert st.a_lo is not None
    rng = np.random.default_rng(23)
    centers = a.reshape(-1, 12, 3).mean(axis=1)
    pts = (np.repeat(centers, 13, axis=0)
           + rng.normal(scale=1.5, size=(40 * 13, 3))).astype(np.float32)
    sid, dist = nearest_tight(st, pts, wide=wide, device=CPU)
    sid, dist = sid.numpy(), dist.numpy().astype(np.float64)
    d2 = point_d2(torch.from_numpy(pts).double()[:, None],
                  *(torch.from_numpy(x).double()[None] for x in (a, b, c))
                  ).numpy()
    best = d2.min(axis=1)
    bd = np.sqrt(best)
    assert (sid >= 0).all()
    own = d2[np.arange(len(pts)), sid]
    assert (own <= best * (1.0 + NEAR_TIE_RTOL)).all()
    assert (np.abs(dist - bd) <= 1e-5 * bd + 1e-2).all()
    rounded, _ = nearest_tight(st._replace(a_lo=None), pts, wide=wide,
                               device=CPU)
    assert int(rounded[326]) == 302 and int(d2[326].argmin()) == 307
    assert int(sid[326]) == 307


def test_nearest_update_takes_the_delta_frames():
    """An update's chain (the host static part with its build's ``a_lo``,
    delta parts with theirs) on create_n_cubes(40) with a third of the
    triangles moved: ``nearest_chained`` reports float64 brute force's
    nearest triangle over the moved scene within the near-tie class on
    every point, and
    ``count_visits_nearest`` on a delta part walks its frame (the counting
    plain walk with ``a_lo``, from the bound seed)."""
    a, b, c = tb.create_n_cubes(40)
    a2, b2, c2, moved_ids = tb.randomly_transform_scene(a, b, c, len(a) // 3,
                                                        seed=11)
    scene = build_tight_scene(a, b, c, use_native=False)
    ch = make_updater(scene, max_moved=len(moved_ids), device=CPU)(
        a2, b2, c2, moved_ids.astype(np.int32))
    assert np.array_equal(_np(ch.parts[0].a_lo), scene.a_lo)
    assert all(p.a_lo is not None for p in ch.parts[1:])
    rng = np.random.default_rng(31)
    centers = (a2 + b2 + c2) / np.float32(3)
    pts = (centers[rng.integers(0, len(a2), 600)]
           + rng.normal(scale=2.0, size=(600, 3))).astype(np.float32)
    sid, _ = nearest_chained(ch, pts, device=CPU)
    d2 = point_d2(torch.from_numpy(pts).double()[:, None],
                  *(torch.from_numpy(x).double()[None] for x in (a2, b2, c2))
                  ).numpy()
    sid = sid.numpy()
    assert (sid >= 0).all()
    own = d2[np.arange(len(pts)), sid]
    assert (own <= d2.min(axis=1) * (1.0 + NEAR_TIE_RTOL)).all()
    delta = ch.parts[1]
    steps, fires = count_visits_nearest(delta, pts, packet=128, device=CPU)
    rows = torch.stack([*torch.from_numpy(pts).T,
                        torch.full((len(pts),), float("inf"))])
    # the walk as nearest_tight runs it: from the bound seed, whose group
    # tests add to the steps
    assert not delta.masked
    seed_tests = nearest_seed_plain(delta.gnodes, rows, counts=True)
    plain = nearest_wide_plain(delta.gnodes, delta.groups, rows,
                               int(delta.width), refine=not delta.masked,
                               counts=True, a_lo=delta.a_lo)
    assert int(steps.sum()) == int(plain[2].sum() + seed_tests.sum())
    assert int(fires.sum()) == int(plain[3].sum())
