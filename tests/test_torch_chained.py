"""The port's chained scenes (build_chained_scene, the chained closest-hit,
any-hit and nearest queries) against bvh_tpu (Pallas in interpret mode).

Tolerances:

* Builds: every part's TightScene fields and every ``orig_ids`` array
  array-equal (``equal_nan`` for the NaN-padded wide tables), for both
  ``use_native`` paths, packed parts, and a chain whose parts' automatic
  leaf widths diverge.
* Closest hit vs the reference's ``trace_closest_hit_chained`` with its
  reciprocal made exact (``exact_reciprocal``): hit masks equal; where the
  ids agree, t equal but on at most 1% of the hits, which may sit one key
  step (W ulps) apart; ids differ on at most 1% of the hits (at least 8
  allowed), each with t within ``GRAZING_RTOL`` (the near-tie and
  grazing-edge classes, which part boundaries can double, trace.py:2400).
  With ``tris``, t within 1e-5 of the reference where the ids agree.
* Any hit vs the reference's ``trace_any_hit_chained``: equal except on
  rays whose nearest hit lies within ``GRAZING_RTOL`` of t_max.
* Nearest vs the reference's ``nearest_chained``: the masks equal, distances
  within rtol 1e-5, atol 1e-5, ids equal but where the two winners'
  brute-force distances agree within 1e-5 (the tie and key-truncation
  class), as tests/test_torch_nearest.py holds ``nearest_tight``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bvh_tpu
from bvh_tpu import tri as tri_j
from bvh_tpu.ops import cluster as cluster_j
from bvh_tpu.ops.nearest import nearest_chained as nearest_chained_j
from bvh_tpu.ops.trace import trace_any_hit_chained as any_chained_j
from bvh_tpu.ops.trace import trace_closest_hit_chained as closest_chained_j
from bvh_tpu_torch import Ray, ray_intersects_triangle
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import cluster as cluster_t
from bvh_tpu_torch.ops import trace as trace_mod
from bvh_tpu_torch.ops import (build_chained_scene, build_tight_scene,
                               chained_scene_from_parts, nearest_chained,
                               nearest_tight, sort_rays_device,
                               trace_any_hit_chained,
                               trace_closest_hit_chained,
                               trace_closest_hit_tight)
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
PACKET = 128
GRAZING_RTOL = 3e-3


@pytest.fixture(scope="module")
def world():
    """create_n_cubes(120), 1,440 triangles, as four parts of at most 400;
    512 rays aimed at the cubes (30% turned away) and 256 points."""
    a, b, c = tb.create_n_cubes(120)
    rng = np.random.default_rng(2)
    centers = a.reshape(-1, 12, 3).mean(axis=1)
    n = 512
    idx = np.resize(np.arange(len(centers)), n)
    offs = rng.normal(size=(n, 3)).astype(np.float32)
    offs /= np.linalg.norm(offs, axis=1, keepdims=True)
    o = (centers[idx] + offs * 40.0).astype(np.float32)
    d = (centers[idx] + 0.17 - o).astype(np.float32)
    flip = rng.random(n) < 0.3
    d[flip] = offs[flip]
    cen = (a + b + c) / np.float32(3)
    pts = np.concatenate([
        cen[rng.integers(0, len(cen), 192)] + rng.normal(scale=20.0,
                                                         size=(192, 3)),
        rng.uniform(-1.2e5, 1.2e5, (64, 3))]).astype(np.float32)
    return (a, b, c), o, d, pts


@pytest.fixture
def exact_reciprocal(monkeypatch):
    """The reference's approximate reciprocal (bfloat16 in interpret mode)
    made exact for one test; compiled traces are dropped before and after."""
    jax.clear_caches()
    monkeypatch.setattr(pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _assert_chain_equal(cj, ct):
    assert len(cj.parts) == len(ct.parts) and len(ct.orig_ids) == len(ct.parts)
    for pj, pt in zip(cj.parts, ct.parts):
        assert pt._fields == pj._fields + ("a_lo",)
        for name in pj._fields:
            x, y = getattr(pj, name), getattr(pt, name)
            if x is None or y is None:
                assert x is None and y is None, name
            elif isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, name
                assert np.array_equal(x, y, equal_nan=(name == "gnodes")), name
            else:
                assert x == y, name
    for ij, it in zip(cj.orig_ids, ct.orig_ids):
        assert it.dtype == np.int32 and np.array_equal(ij, it)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


# ---- builds -----------------------------------------------------------------

@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("kwargs", [{}, {"packed": True}, {"leaf_size": 32},
                                    {"bmat": True, "collapse": None}])
def test_build_chained_scene_equal(use_native, kwargs):
    a, b, c = tb.create_n_cubes(300)  # 3,600 triangles
    cj = cluster_j.build_chained_scene(a, b, c, max_part=1000,
                                       use_native=use_native, **kwargs)
    ct = build_chained_scene(a, b, c, max_part=1000, use_native=use_native,
                             **kwargs)
    assert len(ct.parts) == 4
    _assert_chain_equal(cj, ct)
    # every triangle in exactly one part, parts padded to one shape
    assert np.array_equal(np.sort(np.concatenate(ct.orig_ids)),
                          np.arange(a.shape[0]))
    assert len({(p.smem_nodes.shape, p.groups.shape) for p in ct.parts}) == 1
    _assert_chain_equal(cj, chained_scene_from_parts(
        [p._asdict() for p in cj.parts], cj.orig_ids))


def test_build_chained_single_part():
    a, b, c = tb.create_n_cubes(20)
    ct = build_chained_scene(a, b, c)
    _assert_chain_equal(cluster_j.build_chained_scene(a, b, c), ct)
    assert len(ct.parts) == 1
    assert np.array_equal(ct.orig_ids[0], np.arange(a.shape[0]))


@pytest.mark.parametrize("use_native", [True, False])
def test_build_chained_pins_diverging_widths(use_native, monkeypatch):
    """A chain whose parts' automatic leaf widths diverge is rebuilt at the
    widest. Real divergence needs parts of ~300k triangles; here both
    packages' part builds are made to widen the first part to 32."""
    a, b, c = tb.create_n_cubes(200)
    for mod in (cluster_j, cluster_t):
        build = mod.build_tight_scene
        calls = []

        def widened(*args, _build=build, _calls=calls, **kw):
            if kw.get("leaf_size") is None and not _calls:
                kw["leaf_size"] = 32
            _calls.append(kw.get("leaf_size"))
            return _build(*args, **kw)

        monkeypatch.setattr(mod, "build_tight_scene", widened)
    cj = cluster_j.build_chained_scene(a, b, c, max_part=800,
                                       use_native=use_native)
    ct = build_chained_scene(a, b, c, max_part=800, use_native=use_native)
    assert {int(p.width) for p in ct.parts} == {32}
    _assert_chain_equal(cj, ct)


# ---- closest hit --------------------------------------------------------------

def _chain(tris, **kwargs):
    return (cluster_j.build_chained_scene(*tris, max_part=400, **kwargs),
            build_chained_scene(*tris, max_part=400, **kwargs))


def assert_tie_class(ref, got, W):
    """``ref``/``got``: (t, shape_id) numpy pairs; see the module notes."""
    (t_r, s_r), (t_g, s_g) = ref, got
    hit = np.isfinite(t_r)
    assert (np.isfinite(t_g) == hit).all()
    assert ((s_r >= 0) == hit).all() and ((s_g >= 0) == hit).all()
    same = hit & (s_r == s_g)
    step = np.abs(_bits(t_r)[same].astype(np.int64) - _bits(t_g)[same])
    assert (step <= W).all() and (step != 0).sum() <= max(2, hit.sum() // 100)
    diff = hit & (s_r != s_g)
    assert diff.sum() <= max(8, hit.sum() // 100)
    np.testing.assert_allclose(t_g[diff], t_r[diff], rtol=GRAZING_RTOL)


@pytest.mark.parametrize("case", ["plain", "t_max_perm_tris", "packed",
                                  "partial_packet"])
def test_closest_chained_matches_reference(world, case, exact_reciprocal):
    tris, o, d, _ = world
    if case == "partial_packet":
        # the reference pads the last packet with far rays; the port's root
        # gates look at the real rays of a partial packet only
        o, d = o[:450], d[:450]
    cj, ct = _chain(tris, packed=case == "packed")
    assert len(ct.parts) == 4
    n = len(o)
    kw_j, kw_t = {}, {}
    if case == "t_max_perm_tris":
        t_max = np.random.default_rng(4).uniform(20, 60, n).astype(np.float32)
        perm, _ = sort_rays_device(o, d, mode="morton", device=CPU)
        kw_t = dict(t_max=t_max, perm=perm, tris=tris)
        kw_j = dict(t_max=jnp.asarray(t_max),
                    perm=jnp.asarray(perm.numpy().astype(np.int32)),
                    tris=tuple(jnp.asarray(x) for x in tris))
    hj = closest_chained_j(cj, bvh_tpu.Ray.create(o, d), packet=PACKET,
                           interpret=True, **kw_j)
    ht = trace_closest_hit_chained(ct, Ray.create(o, d, device=CPU),
                                   packet=PACKET, device=CPU, **kw_t)
    t_r, s_r = np.asarray(hj.t), np.asarray(hj.shape_id)
    t_g, s_g = ht.t.numpy(), ht.shape_id.numpy()
    hit = np.isfinite(t_r)
    assert 0.3 < hit.mean() < 0.9
    if case == "t_max_perm_tris":
        assert np.array_equal(np.isfinite(t_g), hit)
        same = hit & (s_r == s_g)
        assert (hit & ~same).sum() <= max(8, hit.sum() // 100)
        np.testing.assert_allclose(t_g[same], t_r[same], rtol=1e-5)
        np.testing.assert_allclose(ht.u.numpy()[same], np.asarray(hj.u)[same],
                                   atol=1e-4)
    else:
        assert_tie_class((t_r, s_r), (t_g, s_g), ct.parts[0].width)
    # the sweep gate and the parts' root gates change no bit
    h2 = trace_closest_hit_chained(ct, Ray.create(o, d, device=CPU),
                                   packet=256, sweep=False, device=CPU,
                                   **kw_t)
    assert np.array_equal(_bits(h2.t), _bits(t_g))
    assert np.array_equal(h2.shape_id.numpy(), s_g)


def test_closest_chained_matches_brute_force(world, monkeypatch):
    """The chain against brute force over all triangles, and against one
    tight scene of the whole set (the reference's test_chained bounds)."""
    tris, o, d, _ = world
    _, ct = _chain(tris, use_native=False)
    rays = Ray.create(o, d, device=CPU)
    away = np.full((PACKET, 3), 5e5, np.float32), np.tile(
        np.array([[1.0, 0.2, 0.1]], np.float32), (PACKET, 1))
    gates, root_gate = [], trace_mod._part_root_gate

    def record(*args):
        gates.append(root_gate(*args))
        return gates[-1]

    monkeypatch.setattr(trace_mod, "_part_root_gate", record)
    got = trace_closest_hit_chained(ct, rays, tris=tris, packet=PACKET,
                                    device=CPU)
    n_gates = len(gates)
    miss = trace_closest_hit_chained(ct, Ray.create(*away, device=CPU),
                                     packet=PACKET, device=CPU)
    # one root gate per part and call; a packet that misses every part's
    # root box is gated off in every part
    assert n_gates == len(ct.parts) and len(gates) == 2 * len(ct.parts)
    assert all(g.dtype == torch.int32 and g.shape == (len(o) // PACKET,)
               for g in gates[:n_gates])
    assert all(g.tolist() == [0] for g in gates[n_gates:])
    assert not torch.isfinite(miss.t).any()
    a_, b_, c_ = (torch.from_numpy(x)[None] for x in tris)
    tw = ray_intersects_triangle(Ray(*(x[:, None] for x in rays)), a_, b_,
                                 c_).distance.amin(dim=1).numpy()
    tg = got.t.numpy()
    assert np.array_equal(np.isfinite(tg), np.isfinite(tw))
    both = np.isfinite(tg)
    np.testing.assert_allclose(tg[both], tw[both], rtol=1e-2)
    assert (np.abs(tg[both] / tw[both] - 1) < 3e-3).mean() > 0.95
    whole = trace_closest_hit_tight(build_tight_scene(*tris), rays, tris=tris,
                                    packet=PACKET, device=CPU)
    assert (whole.shape_id.numpy() == got.shape_id.numpy()).mean() > 0.99
    # a single-part chain is the tight trace itself
    one = build_chained_scene(*tris)
    h1 = trace_closest_hit_chained(one, rays, packet=PACKET, device=CPU)
    h0 = trace_closest_hit_tight(one.parts[0], rays, packet=PACKET,
                                 device=CPU)
    assert np.array_equal(_bits(h1.t), _bits(h0.t))
    assert torch.equal(h1.shape_id, h0.shape_id)


# ---- any hit ------------------------------------------------------------------

@pytest.mark.parametrize("bound", ["none", "per_ray", "per_ray_perm"])
def test_any_chained_matches_reference(world, bound, exact_reciprocal):
    tris, o, d, _ = world
    cj, ct = _chain(tris)
    n = len(o)
    t_max, perm = None, None
    if bound != "none":
        t_max = np.random.default_rng(8).uniform(5, 80, n).astype(np.float32)
    if bound == "per_ray_perm":
        perm, _ = sort_rays_device(o, d, mode="morton", device=CPU)
    ref = np.asarray(any_chained_j(
        cj, bvh_tpu.Ray.create(o, d), packet=PACKET, interpret=True,
        t_max=None if t_max is None else jnp.asarray(t_max),
        perm=None if perm is None else jnp.asarray(perm.numpy()
                                                    .astype(np.int32))))
    got = trace_any_hit_chained(ct, Ray.create(o, d, device=CPU), t_max=t_max,
                                packet=PACKET, perm=perm, device=CPU)
    assert got.dtype == torch.bool and got.shape == (n,)
    got = got.numpy()
    assert 0 < got.sum() < n
    # the closest hit decides the occlusion, up to the key truncation
    hc = trace_closest_hit_chained(ct, Ray.create(o, d, device=CPU),
                                   tris=tris, perm=perm, device=CPU)
    tc = hc.t.numpy()
    tm = np.broadcast_to(np.inf if t_max is None else t_max, (n,))
    if perm is not None:
        tm = tm[perm.numpy()]
    gap = np.abs(tc - np.where(np.isfinite(tm), tm, 0.0))
    near = np.isfinite(tm) & (gap <= GRAZING_RTOL * tm)
    assert near.sum() <= 4
    assert np.array_equal(got[~near], (tc < tm)[~near])
    assert np.array_equal(ref[~near], got[~near])


# ---- nearest ------------------------------------------------------------------

def _winner_d(pts, sid, a, b, c):
    s = np.maximum(sid, 0)
    return np.sqrt(np.asarray(tri_j.point_triangle_distance_squared(
        jnp.asarray(pts), jnp.asarray(a[s]), jnp.asarray(b[s]),
        jnp.asarray(c[s]))))


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("dm", [None, "per_point"])
def test_nearest_chained_matches_reference(world, dm, sort):
    tris, _, _, pts = world
    cj, ct = _chain(tris)
    d_max = None
    if dm == "per_point":
        _, bd = nearest_tight(build_tight_scene(*tris), pts, device=CPU)
        d_max = (np.random.default_rng(8).uniform(0, 2, len(pts))
                 * bd.numpy()).astype(np.float32)
    sid_j, d_j = (np.asarray(x) for x in nearest_chained_j(
        cj, jnp.asarray(pts), packet=PACKET, interpret=True, sort=sort,
        d_max=None if d_max is None else jnp.asarray(d_max)))
    sid_t, d_t = nearest_chained(ct, pts, packet=PACKET, d_max=d_max,
                                 sort=sort, device=CPU)
    assert sid_t.dtype == torch.int32 and d_t.dtype == torch.float32
    sid_t, d_t = sid_t.numpy(), d_t.numpy()
    hit = sid_j >= 0
    assert np.array_equal(sid_t >= 0, hit)
    assert np.array_equal(np.isposinf(d_t), ~hit)
    np.testing.assert_allclose(d_t[hit], d_j[hit], rtol=1e-5, atol=1e-5)
    diff = hit & (sid_t != sid_j)
    if diff.any():
        np.testing.assert_allclose(_winner_d(pts[diff], sid_t[diff], *tris),
                                   _winner_d(pts[diff], sid_j[diff], *tris),
                                   rtol=1e-5, atol=0)
    if d_max is None:
        assert hit.all()
    else:
        assert 0 < hit.sum() < len(pts)
    # a chain of one part answers as nearest_tight over that part, bit for
    # bit: the same sort, walk and un-sort
    one = build_chained_scene(*tris)
    assert len(one.parts) == 1
    for x, y in zip(nearest_chained(one, pts, packet=PACKET, d_max=d_max,
                                    sort=sort, device=CPU),
                    nearest_tight(one.parts[0], pts, packet=PACKET,
                                  d_max=d_max, sort=sort, device=CPU)):
        assert np.array_equal(_bits(x), _bits(y))


def test_chained_empty_inputs(world):
    tris, *_ = world
    _, ct = _chain(tris)
    z = np.zeros((0, 3), np.float32)
    h = trace_closest_hit_chained(ct, Ray.create(z, z, device=CPU), device=CPU)
    assert h.t.shape == (0,) and h.shape_id.dtype == torch.int32
    assert trace_any_hit_chained(ct, Ray.create(z, z, device=CPU),
                                 device=CPU).shape == (0,)
    sid, dist = nearest_chained(ct, z, device=CPU)
    assert sid.shape == (0,) and dist.shape == (0,)
    with pytest.raises(ValueError, match="power of two"):
        trace_closest_hit_chained(ct, Ray.create(z, z, device=CPU),
                                  packet=300, device=CPU)
