"""The port's trace path as a whole (make_tracer, trace_closest_hit_tight
with tris, t_max and perm) against bvh_tpu run in interpret mode and against
a brute-force oracle, on create_n_cubes(120) with reference-random,
aimed and near rays.

Tolerances: hit masks equal; where shape ids agree, the exact (u, v, t)
winner recompute agrees within 1e-5 relative (both recompute with
float32 Moller-Trumbore; the normalized directions may differ in the last
bit); ids may differ on at most 1% of the hits, only in the near-tie and
grazing-edge classes (t within 0.3%, PARITY.md). Against brute force the
port's masks are equal and t within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bvh_tpu
from bvh_tpu.ops.cluster import build_tight_scene as build_j
from bvh_tpu.ops.trace import make_tracer as make_tracer_j
from bvh_tpu.ops.trace import trace_closest_hit_tight as trace_j
from bvh_tpu_torch import Ray, ray_intersects_triangle
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import (build_tight_scene, make_tracer,
                               scene_from_arrays, sort_rays_device,
                               trace_closest_hit_tight)
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
N_CUBES = 120
GRAZING_RTOL = 3e-3
EXACT_RTOL = 1e-5


@pytest.fixture(scope="module")
def world():
    a, b, c = tb.create_n_cubes(N_CUBES)
    o1, d1 = tb.create_rays(1024, seed=tb.seed_state_after(N_CUBES))
    o2, d2 = tb.aimed_rays(a, 2048, seed=5)
    rng = np.random.default_rng(7)
    centers = (a + b + c) / np.float32(3)
    o3 = (centers[rng.integers(0, len(a), 1024)]
          + rng.uniform(-30, 30, (1024, 3))).astype(np.float32)
    d3 = rng.normal(size=(1024, 3)).astype(np.float32)
    o = np.concatenate([o1, o2, o3])
    d = np.concatenate([d1, d2, d3])
    return (a, b, c), o, d


def brute_force(tris, o, d):
    a, b, c = (torch.from_numpy(x) for x in tris)
    rays = Ray.create(o, d, device=CPU)
    out = []
    for s in range(0, len(o), 256):
        r = Ray(*(x[s:s + 256, None, :] for x in rays))
        out.append(ray_intersects_triangle(r, a[None], b[None], c[None])
                   .distance.amin(dim=1))
    return torch.cat(out).numpy()


def assert_same_hits(ref, got, exact_rtol=EXACT_RTOL, uv_atol=1e-4):
    """``ref``/``got``: (t, u, v, shape_id) numpy tuples in one ray order."""
    t_r, u_r, v_r, s_r = ref
    t_g, u_g, v_g, s_g = got
    hit = np.isfinite(t_r)
    assert (np.isfinite(t_g) == hit).all()
    assert ((s_r >= 0) == hit).all() and ((s_g >= 0) == hit).all()
    same = hit & (s_r == s_g)
    np.testing.assert_allclose(t_g[same], t_r[same], rtol=exact_rtol)
    np.testing.assert_allclose(u_g[same], u_r[same], atol=uv_atol)
    np.testing.assert_allclose(v_g[same], v_r[same], atol=uv_atol)
    diff = hit & (s_r != s_g)
    np.testing.assert_allclose(t_g[diff], t_r[diff], rtol=GRAZING_RTOL)
    assert diff.sum() <= max(8, hit.sum() // 100)


def as_np(h):
    return tuple(np.asarray(x) for x in h)


def test_make_tracer_matches_reference_and_oracle(world):
    tris, o, d = world
    sj = build_j(*tris)
    st = build_tight_scene(*tris)
    ref = make_tracer_j(sj, packet=1024, sort="octmorton", tris=tris,
                        interpret=True)(o, d)
    got = make_tracer(st, packet=1024, sort="octmorton", tris=tris,
                      device=CPU)(o, d)
    ref, got = as_np(ref), as_np(got)
    assert 0.3 < np.isfinite(got[0]).mean() < 0.95
    assert_same_hits(ref, got)
    t_bf = brute_force(tris, o, d)
    assert (np.isfinite(t_bf) == np.isfinite(got[0])).all()
    hit = np.isfinite(t_bf)
    np.testing.assert_allclose(got[0][hit], t_bf[hit], rtol=EXACT_RTOL)


@pytest.fixture
def exact_reciprocal(monkeypatch):
    """The reference's approximate reciprocal (bfloat16 in interpret mode)
    made exact for one test; compiled traces are dropped before and after."""
    jax.clear_caches()
    monkeypatch.setattr(pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def test_trace_tight_tris_tmax_perm_matches_reference(world, exact_reciprocal):
    tris, o, d = world
    n = len(o)
    rng = np.random.default_rng(11)
    t_max = rng.uniform(10, 80, n).astype(np.float32)
    sj = build_j(*tris)
    st = build_tight_scene(*tris)
    perm, _ = sort_rays_device(o, d, mode="morton", device=CPU)
    ref = trace_j(sj, bvh_tpu.Ray.create(o, d), tris=tris, t_max=t_max,
                  perm=np.asarray(perm, np.int32), interpret=True, packet=512)
    got = trace_closest_hit_tight(st, Ray.create(o, d, device=CPU), tris=tris,
                                  t_max=t_max, perm=perm, packet=512,
                                  device=CPU)
    ref, got = as_np(ref), as_np(got)
    tm = t_max[perm.numpy()]
    hit = np.isfinite(got[0])
    assert 0 < hit.sum() < n
    assert (got[0][hit] < tm[hit]).all()
    # a hit within the key truncation of t_max may fall on either side
    free = as_np(trace_closest_hit_tight(st, Ray.create(o, d, device=CPU),
                                         tris=tris, perm=perm, device=CPU))
    band = np.abs(free[0] - tm) <= 2 * 16 * 2.0 ** -23 * tm
    assert band.sum() <= 2
    assert_same_hits(tuple(x[~band] for x in ref), tuple(x[~band] for x in got))
    # the bound only drops hits: unbounded hits below t_max are kept
    keep = np.isfinite(free[0]) & (free[0] < tm * 0.999)
    assert (got[3][keep] == free[3][keep]).all()


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


@pytest.mark.parametrize("sort", ["octant", "morton", "octmorton", None])
def test_results_do_not_depend_on_sort_or_sweep(world, sort):
    """Each ray walks on its own, so the coherence sort and the sweep gate
    change no bit of the results; and the tracer's answers are
    ``trace_closest_hit_tight(perm=)``'s under the same sort, un-sorted."""
    tris, o, d = world
    st = build_tight_scene(*tris)
    rays = Ray.create(o, d, device=CPU)
    base = trace_closest_hit_tight(st, rays, tris=tris, device=CPU)
    for sweep in (False, True):
        got = make_tracer(st, packet=256, sweep=sweep, sort=sort, tris=tris,
                          device=CPU)(o, d)
        for x, y in zip(base, got):
            assert torch.equal(_bits(x), _bits(y))
    if sort is not None:
        perm, inv = sort_rays_device(o, d, bits=2, mode=sort, device=CPU)
        sorted_hits = trace_closest_hit_tight(st, rays, tris=tris, perm=perm,
                                              packet=256, device=CPU)
        for x, y in zip(sorted_hits, got):
            assert torch.equal(_bits(x[inv]), _bits(y))


def test_carried_scene_traces_identically(world):
    tris, o, d = world
    carried = scene_from_arrays(build_j(*tris)._asdict())
    own = build_tight_scene(*tris)
    rays = Ray.create(o, d, device=CPU)
    h1 = trace_closest_hit_tight(carried, rays, sweep=True, device=CPU)
    h2 = trace_closest_hit_tight(own, rays, sweep=True, device=CPU)
    assert torch.equal(h1.t.view(torch.int32), h2.t.view(torch.int32))
    assert torch.equal(h1.shape_id, h2.shape_id)


def test_leaf_width_64_matches_reference(world):
    tris, o, d = world
    sj = build_j(*tris, leaf_size=64)
    st = build_tight_scene(*tris, leaf_size=64)
    ref = as_np(trace_j(sj, bvh_tpu.Ray.create(o, d), tris=tris, packet=1024,
                        interpret=True))
    got = as_np(trace_closest_hit_tight(st, Ray.create(o, d, device=CPU),
                                        tris=tris, packet=1024, device=CPU))
    assert_same_hits(ref, got)


def test_empty_and_unported(world):
    tris, o, d = world
    st = build_tight_scene(*tris)
    empty = make_tracer(st, device=CPU)(o[:0], d[:0])
    assert empty.t.shape == (0,) and empty.shape_id.dtype == torch.int32
    rays = Ray.create(o, d, device=CPU)
    p = -(-len(o) // 2048)
    # hints, pre_gate, wide=False and scenes without gnodes are ported
    for kw in ({"hints": np.full((p, 1), -1, np.int32)},
               {"pre_gate": np.ones(p)}, {"wide": False}):
        trace_closest_hit_tight(st, rays, device=CPU, **kw)
    trace_closest_hit_tight(st._replace(gnodes=None), rays, device=CPU)
    # subtree entries and the key plan are ported: they run and change no
    # result
    plain = trace_closest_hit_tight(st, rays, device=CPU)
    gn = st.gnodes.shape[1]
    for sg in (np.zeros(p), np.arange(p) % gn,
               np.stack([np.arange(p) % gn, np.full(p, gn - 1)], 1)):
        got = trace_closest_hit_tight(st, rays, device=CPU, start_g=sg)
        for x, y in zip(got, plain):
            assert torch.equal(x, y)
    keyed = make_tracer(st, plan="key", sort="morton", device=CPU)(o, d)
    for x, y in zip(keyed, make_tracer(st, sort="morton", device=CPU)(o, d)):
        assert torch.equal(x, y)
    # ... on the group walk only, and with ids of the wide table
    with pytest.raises(ValueError, match="start_g"):
        trace_closest_hit_tight(st, rays, device=CPU, wide=False,
                                start_g=np.zeros(p))
    with pytest.raises(ValueError, match="Gn"):
        trace_closest_hit_tight(st, rays, device=CPU,
                                start_g=np.full(p, gn))
    with pytest.raises(ValueError, match="packet"):
        make_tracer(st, packet=1000, device=CPU)
    with pytest.raises(ValueError, match="hints"):
        trace_closest_hit_tight(st, rays, device=CPU,
                                hints=np.zeros((1, 1), np.int32))
