"""The port's general pure-tensor path against bvh_tpu on the same seeded
inputs: boxes, balls and queries (``aabb.py``, ``ball.py``,
``queries.py``), the batched stackless traversals (``bvh/traverse.py``),
the ordered walks (``bvh/ordered.py``), the validators
(``bvh/validate.py``, ``ops/validate_scene.py``) and ``render_hits`` /
``render_depth`` (``diff/render.py``). Inputs are numpy arrays made from
seeds and handed to both packages; everything runs on the CPU.

Tolerances:

* Boxes, balls, queries: predicates and the min/max algebra equal; the
  measures (size, centre, area, volume, box distance) within rtol 1e-6
  (sums over D may be taken in another order).
* ``traverse``, ``traverse_all``, the ordered walks, the brute-force
  collect: hit sets, counts and buffers equal; ordered distances within
  rtol 1e-6.
* Closest and any hit, nearest: equal hit masks; t and d^2 within rtol
  1e-6 (u and v within 1e-4); ids equal outside the near-tie class (the other id's t or d^2
  within rtol 1e-6 of the same value).
* Validators: the reference's messages, and [] on the port's scenes.
* Rendering: forward equal (t within rtol 1e-6, ids equal); gradients of
  the loss within rtol 1e-4 of the largest against ``jax.grad`` of the
  reference's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import bvh_tpu as J
from bvh_tpu import bvh as bvh_j
from bvh_tpu import diff as diff_j
from bvh_tpu import ops as ops_j
import bvh_tpu_torch as T
from bvh_tpu_torch import obs
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.bvh import (FlatBvh, any_hit_triangles,
                               brute_force_closest_hit, brute_force_collect,
                               build_sah, check_consistent, check_tight,
                               closest_hit_chunked, closest_hit_triangles,
                               farthest_traverse, nearest_to,
                               nearest_to_triangles, nearest_traverse,
                               ordered_traverse, traverse, traverse_all)
from bvh_tpu_torch.diff import render_depth, render_hits
from bvh_tpu_torch.ops import (assert_tight_scene, build_chained_scene,
                               build_chained_scene_device, build_tight_scene,
                               build_tight_scene_device, check_tight_scene,
                               make_refitter)
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
# the module (``bvh_tpu_torch.bvh.traverse`` names the function)
trav_mod = importlib.import_module("bvh_tpu_torch.bvh.traverse")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(x, y):
    x, y = _n(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape
    assert np.array_equal(x, y, equal_nan=True)


def _close(x, y, rtol=1e-6):
    x, y = _n(x), np.asarray(y)
    assert x.shape == y.shape
    np.testing.assert_allclose(x, y, rtol=rtol, atol=0)


# ---- boxes, balls, queries ---------------------------------------------------

def _boxes(d, dtype, seed, n=64):
    rng = np.random.default_rng(seed)
    p1, p2 = rng.uniform(-50, 50, (2, n, d)).astype(dtype)
    lo, hi = np.minimum(p1, p2), np.maximum(p1, p2)
    lo[::7] = hi[::7] + 1  # a few empty boxes
    pts = rng.uniform(-60, 60, (n, d)).astype(dtype)
    return lo, hi, pts


AABB_METHODS = [("contains", "p"), ("approx_contains_eps", "p", 1e-3),
                ("approx_contains_aabb_eps", "o", 1e-3),
                ("relative_eq", "o", 20.0), ("intersects_aabb", "o"),
                ("is_empty",), ("join", "o"), ("grow", "p"),
                ("join_reduce", 0), ("size",), ("center",), ("half_size",),
                ("surface_area",), ("volume",), ("largest_axis",),
                ("min_distance_squared", "p")]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("method", AABB_METHODS, ids=lambda m: m[0])
def test_aabb_methods(method, d, dtype):
    """Every ``Aabb`` method on the same boxes, any D, float32 and float64:
    exact for predicates and min/max, rtol 1e-6 for the measures."""
    lo, hi, pts = _boxes(d, dtype, seed=d)
    lo2, hi2, _ = _boxes(d, dtype, seed=d + 10)
    name, *args = method
    with jax.enable_x64(dtype == np.float64):
        aj, oj = J.Aabb(jnp.asarray(lo), jnp.asarray(hi)), \
            J.Aabb(jnp.asarray(lo2), jnp.asarray(hi2))
        at = T.Aabb.with_bounds(lo, hi, device=CPU)
        ot = T.Aabb.with_bounds(lo2, hi2, device=CPU)
        conv = {"p": (jnp.asarray(pts), _t(pts)), "o": (oj, ot)}
        aj_args = [conv[x][0] if isinstance(x, str) else x for x in args]
        at_args = [conv[x][1] if isinstance(x, str) else x for x in args]
        want = getattr(aj, name)(*aj_args)
        got = getattr(at, name)(*at_args)
        pairs = (list(zip(got, want)) if isinstance(want, tuple)
                 else [(got, want)])
        for g, w in pairs:
            w = np.asarray(w)
            if name in ("size", "center", "half_size", "surface_area",
                        "volume", "min_distance_squared"):
                assert _n(g).dtype == w.dtype
                _close(g, w)
            elif name == "largest_axis":
                assert np.array_equal(_n(g), w)
            else:
                _same(g, w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_aabb_constructors(dtype):
    with jax.enable_x64(dtype == np.float64):
        tdt = torch.float64 if dtype == np.float64 else torch.float32
        for name in ("empty", "infinite"):
            want = getattr(J.Aabb, name)(4, (3,), dtype=jnp.dtype(dtype))
            got = getattr(T.Aabb, name)(4, (3,), dtype=tdt, device=CPU)
            for g, w in zip(got, want):
                _same(g, w)
        pts = np.random.default_rng(0).normal(size=(5, 7, 3)).astype(dtype)
        for g, w in zip(T.Aabb.from_points(_t(pts)),
                        J.Aabb.from_points(jnp.asarray(pts))):
            _same(g, w)
    big = T.Aabb.with_bounds(np.full(3, 3e38, np.float32),
                             np.full(3, 3.2e38, np.float32), device=CPU)
    assert torch.isfinite(big.center()).all()  # overflow-safe midpoint
    e = T.Aabb.empty(device=CPU)
    p = torch.tensor([1.0, 2.0, 3.0])
    g = e.grow(p)
    assert torch.equal(g.min, p) and torch.equal(g.max, p)
    assert bool(e.is_empty()) and not bool(g.is_empty())


vec3 = st.lists(st.floats(-1e5, 1e5, allow_nan=False, width=32), min_size=3,
                max_size=3)


def _box(p1, p2):
    lo = np.minimum(p1, p2).astype(np.float32)
    hi = np.maximum(p1, p2).astype(np.float32)
    return T.Aabb.with_bounds(lo, hi, device=CPU), lo, hi


@settings(max_examples=60, deadline=None)
@given(vec3, vec3, vec3)
def test_prop_join_contains_both(p1, p2, p3):
    """The union of two boxes contains points of both."""
    a, lo, hi = _box(p1, p2)
    p3 = np.asarray(p3, np.float32)
    b = T.Aabb.with_bounds(p3, p3 + 1.0, device=CPU)
    j = a.join(b)
    for p in (lo, hi, p3):
        assert bool(j.contains(_t(p)))


@settings(max_examples=60, deadline=None)
@given(vec3, vec3, vec3)
def test_prop_grow_then_contains(p1, p2, q):
    a, _, _ = _box(p1, p2)
    q = _t(np.asarray(q, np.float32))
    assert bool(a.grow(q).contains(q))


@settings(max_examples=40, deadline=None)
@given(vec3, vec3)
def test_prop_surface_volume_grow_monotone(p1, p2):
    a, _, hi = _box(p1, p2)
    bigger = a.grow(_t(hi + 10.0))
    assert float(bigger.surface_area()) >= float(a.surface_area())
    assert float(bigger.volume()) >= float(a.volume())


@pytest.mark.parametrize("d", [2, 3])
def test_ball_and_queries(d):
    """``Ball`` (and its ``Sphere``/``Circle`` names) and the four queries'
    node tests equal the reference's on the same boxes."""
    lo, hi, pts = _boxes(d, np.float32, seed=5 + d)
    rng = np.random.default_rng(d)
    rad = rng.uniform(0.5, 30, len(pts)).astype(np.float32)
    dirs = rng.normal(size=pts.shape).astype(np.float32)
    dirs[::5, 0] = 0.0  # rays in a face plane
    assert T.Sphere is T.Ball and T.Circle is T.Ball
    bj, bt = J.Ball.create(pts, rad), T.Ball.create(pts, rad, device=CPU)
    _same(bt.contains(_t(lo)), bj.contains(jnp.asarray(lo)))
    _same(bt.intersects_aabb(_t(lo), _t(hi)),
          bj.intersects_aabb(jnp.asarray(lo), jnp.asarray(hi)))
    queries = (
        (J.RayQuery(J.Ray.create(pts, dirs)),
         T.RayQuery(T.Ray.create(pts, dirs, device=CPU))),
        (J.AabbQuery(J.Aabb(jnp.asarray(pts - 5), jnp.asarray(pts + 5))),
         T.AabbQuery(T.Aabb.with_bounds(pts - 5, pts + 5, device=CPU))),
        (J.PointQuery(jnp.asarray(pts)), T.PointQuery(_t(pts))),
        (J.BallQuery(bj), T.BallQuery(bt)))
    for qj, qt in queries:
        _same(qt.intersects_node(_t(lo), _t(hi)),
              qj.intersects_node(jnp.asarray(lo), jnp.asarray(hi)))


# ---- scenes ------------------------------------------------------------------

def _grid_tris():
    """Unit cubes at well-separated integer grid positions (the reference's
    exact-agreement scene)."""
    k = 4
    centers = np.stack(np.meshgrid(*[np.arange(k) * 4.0] * 3, indexing="ij"),
                       axis=-1).reshape(-1, 3).astype(np.float32)
    tris = (centers[:, None, None, :] + tb._CUBE_TRIS[None]).reshape(-1, 3, 3)
    return (tris[:, 0], tris[:, 1], tris[:, 2]), centers


@pytest.fixture(scope="module", params=["grid", "cubes"])
def scene(request):
    """(tris, shape boxes, the reference's flat tree, the port's as tensors,
    rays, points) over the grid scene or create_n_cubes(60)."""
    if request.param == "grid":
        (a, b, c), centers = _grid_tris()
        rng = np.random.default_rng(1)
        o = (centers[rng.integers(0, len(centers), 96)]
             + rng.uniform(-30, 30, (96, 3))).astype(np.float32)
        d = (centers[rng.integers(0, len(centers), 96)] + 0.1 - o)
    else:
        a, b, c = tb.create_n_cubes(60)
        o, d = tb.aimed_rays(a, 96, seed=3)
        o2, d2 = tb.create_rays(32, seed=tb.seed_state_after(5))
        o, d = np.concatenate([o, o2]), np.concatenate([d, d2])
    d = d.astype(np.float32)
    mn, mx = tb.tri_aabbs(a, b, c)
    flat, _ = build_sah(mn, mx)
    flat_j, _ = bvh_j.build_sah(mn, mx)
    pts = (a[::9] + np.random.default_rng(2).normal(scale=3.0, size=(
        len(a[::9]), 3))).astype(np.float32)
    return dict(tris=(a, b, c), mn=mn, mx=mx, fj=flat_j.to_device(),
                ft=flat.to_device(device=CPU), o=o, d=d, pts=pts)


def _query_pair(kind, s):
    o, d, pts = s["o"], s["d"], s["pts"][:64]
    if kind == "ray":
        return (J.RayQuery(J.Ray.create(o, d)),
                T.RayQuery(T.Ray.create(o, d, device=CPU)))
    if kind == "aabb":
        return (J.AabbQuery(J.Aabb(jnp.asarray(pts - 4), jnp.asarray(pts + 4))),
                T.AabbQuery(T.Aabb.with_bounds(pts - 4, pts + 4, device=CPU)))
    if kind == "point":
        p = s["mn"][::5] * np.float32(0.5) + s["mx"][::5] * np.float32(0.5)
        return J.PointQuery(jnp.asarray(p)), T.PointQuery(_t(p))
    r = np.full(len(pts), 6.0, np.float32)
    return (J.BallQuery(J.Ball.create(pts, r)),
            T.BallQuery(T.Ball.create(pts, r, device=CPU)))


def _sets(hits):
    return [set(int(x) for x in row if x >= 0) for row in np.asarray(hits)]


@pytest.mark.parametrize("kind", ["ray", "aabb", "point", "ball"])
def test_traverse_equal(scene, kind):
    """Hit sets, counts and buffers equal to the reference's, and to both
    brute-force collects."""
    qj, qt = _query_pair(kind, scene)
    hj, cj = bvh_j.traverse(scene["fj"], qj, max_hits=256)
    ht, ct = traverse(scene["ft"], qt, max_hits=256)
    _same(ht, hj)
    _same(ct, cj)
    assert int(ct.max()) <= 256 and int(ct.sum()) > 0
    mask_j = np.asarray(bvh_j.brute_force_collect(qj, jnp.asarray(scene["mn"]),
                                                   jnp.asarray(scene["mx"])))
    mask_t = brute_force_collect(qt, _t(scene["mn"]), _t(scene["mx"]))
    _same(mask_t, mask_j)
    assert _sets(ht) == [set(np.nonzero(r)[0].tolist()) for r in mask_j]


def test_traverse_overflow_and_regrow(scene):
    """A box over everything with a buffer of 8: the true count, the same
    saturated buffer as the reference's; ``traverse_all`` regrows until
    every shape fits, as the reference's does."""
    mn, mx = scene["mn"], scene["mx"]
    lo, hi = mn.min(axis=0)[None] - 1, mx.max(axis=0)[None] + 1
    qj = J.AabbQuery(J.Aabb(jnp.asarray(lo), jnp.asarray(hi)))
    qt = T.AabbQuery(T.Aabb.with_bounds(lo, hi, device=CPU))
    hj, cj = bvh_j.traverse(scene["fj"], qj, max_hits=8)
    ht, ct = traverse(scene["ft"], qt, max_hits=8)
    assert int(ct[0]) == mn.shape[0]
    _same(ht, hj)
    _same(ct, cj)
    hj, cj = bvh_j.traverse_all(scene["fj"], qj, max_hits=8)
    ht, ct = traverse_all(scene["ft"], qt, max_hits=8)
    _same(ht, hj)
    _same(ct, cj)
    assert sorted(int(x) for x in _n(ht[0]) if x >= 0) == list(range(len(mn)))
    with pytest.raises(ValueError, match="grow_limit"):
        traverse_all(scene["ft"], qt, max_hits=8, grow_limit=16)


def test_empty_bvh():
    """The empty tree: empty buffers and counts, misses everywhere."""
    fj = bvh_j.FlatBvh.empty(3).to_device()
    ft = FlatBvh.empty(3).to_device(device=CPU)
    o, d = np.zeros((4, 3), np.float32), np.ones((4, 3), np.float32)
    hj, cj = bvh_j.traverse(fj, J.RayQuery(J.Ray.create(o, d)), max_hits=4)
    ht, ct = traverse(ft, T.RayQuery(T.Ray.create(o, d, device=CPU)),
                      max_hits=4)
    _same(ht, hj)
    _same(ct, cj)
    e = torch.zeros((0, 3))
    rays = T.Ray.create(o, d, device=CPU)
    got = closest_hit_triangles(ft, rays, e, e, e)
    assert torch.isinf(got.t).all() and (got.shape_id == -1).all()
    assert not any_hit_triangles(ft, rays, e, e, e).any()
    sid, dist = nearest_to_triangles(ft, _t(o), e, e, e)
    assert (sid == -1).all() and torch.isinf(dist).all()
    ids, dist, cnt = nearest_traverse(ft, rays, max_hits=4)
    assert (ids == -1).all() and (cnt == 0).all()


def _tie_ids(t_g, s_g, t_w, s_w, table):
    """Ids equal outside the near-tie class: where they differ, each id's
    own value (``table[ray, id]``) is within rtol 1e-6 of the other's."""
    diff = np.nonzero(s_g != s_w)[0]
    for i in diff:
        assert abs(table[i, s_g[i]] - table[i, s_w[i]]) <= 1e-6 * abs(
            table[i, s_w[i]]), i
    assert len(diff) <= max(2, len(s_g) // 100)


def test_closest_and_any_hit(scene):
    """Closest hit (ordered pruning) and any hit against the reference and
    brute force; ``closest_hit_chunked`` equals the unchunked walk."""
    a, b, c = scene["tris"]
    o, d = scene["o"], scene["d"]
    rj = J.Ray.create(o, d)
    rt = T.Ray.create(o, d, device=CPU)
    tj = tuple(jnp.asarray(x) for x in (a, b, c))
    tt = tuple(_t(x) for x in (a, b, c))
    want = bvh_j.closest_hit_triangles(scene["fj"], rj, *tj)
    got = closest_hit_triangles(scene["ft"], rt, *tt)
    brute = brute_force_closest_hit(rt, *tt)
    brute_j = bvh_j.brute_force_closest_hit(rj, *tj)
    _close(brute.t, brute_j.t)
    _same(brute.shape_id, brute_j.shape_id)
    bh = np.isfinite(np.asarray(brute_j.t))
    for x, y in ((brute.u, brute_j.u), (brute.v, brute_j.v)):
        assert np.abs(_n(x)[bh] - np.asarray(y)[bh]).max() <= 1e-4
    hit = np.isfinite(np.asarray(want.t))
    assert np.array_equal(np.isfinite(_n(got.t)), hit) and hit.any()
    _close(got.t[hit], np.asarray(want.t)[hit])
    all_t = T.ray_intersects_triangle(
        T.Ray(*(x[:, None] for x in rt)), *(x[None] for x in tt)).distance
    _tie_ids(_n(got.t), _n(got.shape_id), np.asarray(want.t),
             np.asarray(want.shape_id), _n(all_t))
    # u and v: within 1e-4 (sums of terms at 1e5 coordinates, taken in
    # another order)
    same = _n(got.shape_id) == np.asarray(want.shape_id)
    for x, y in ((got.u, want.u), (got.v, want.v)):
        assert np.abs(_n(x)[same] - np.asarray(y)[same]).max() <= 1e-4
    ch = closest_hit_chunked(scene["ft"], T.Ray(*(x[:96] for x in rt)), *tt,
                             chunk=32)
    for x, y in zip(ch, closest_hit_triangles(scene["ft"],
                                              T.Ray(*(x[:96] for x in rt)),
                                              *tt)):
        assert torch.equal(x, y)
    tm = np.where(hit, np.asarray(want.t) * 1.2, 50.0).astype(np.float32)
    tm[::2] *= 0.5
    aj = np.asarray(bvh_j.any_hit_triangles(scene["fj"], rj, *tj,
                                            t_max=jnp.asarray(tm)))
    at = any_hit_triangles(scene["ft"], rt, *tt, t_max=_t(tm))
    _same(at, aj)
    assert aj.any() and not aj.all()


def test_results_do_not_depend_on_check_every(scene, monkeypatch):
    """The host reads the stop test every ``CHECK_EVERY`` steps; a finished
    lane's step is a no-op, so any period gives the same results."""
    a, b, c = scene["tris"]
    rt = T.Ray.create(scene["o"], scene["d"], device=CPU)
    tt = tuple(_t(x) for x in (a, b, c))
    base = closest_hit_triangles(scene["ft"], rt, *tt)
    ordered = nearest_traverse(scene["ft"], rt, max_hits=16)
    for k in (1, 3):
        monkeypatch.setattr(trav_mod, "CHECK_EVERY", k)
        steps = obs.counted("traverse.steps")
        reads = obs.counted("traverse.host_reads")
        for x, y in zip(closest_hit_triangles(scene["ft"], rt, *tt), base):
            assert torch.equal(x, y)
        for x, y in zip(nearest_traverse(scene["ft"], rt, max_hits=16),
                        ordered):
            assert torch.equal(x, y)
        assert obs.counted("traverse.host_reads") - reads > 1
        assert (obs.counted("traverse.steps") - steps) % k == 0


def test_nearest(scene):
    """``nearest_to_triangles`` and ``nearest_to`` with a user distance
    (solid balls at the triangles' centroids) against the reference."""
    a, b, c = scene["tris"]
    pts = scene["pts"]
    tj = tuple(jnp.asarray(x) for x in (a, b, c))
    tt = tuple(_t(x) for x in (a, b, c))
    sj, dj = bvh_j.nearest_to_triangles(scene["fj"], jnp.asarray(pts), *tj)
    st_, dt_ = nearest_to_triangles(scene["ft"], _t(pts), *tt)
    _close(dt_ ** 2, np.asarray(dj) ** 2)
    d2 = _n(T.point_triangle_distance_squared(_t(pts)[:, None],
                                              *(x[None] for x in tt)))
    _tie_ids(None, _n(st_), None, np.asarray(sj), d2)
    cen = ((a + b + c) / np.float32(3)).astype(np.float32)
    rad = np.full(len(a), 0.2, np.float32)
    cj_, rj_ = jnp.asarray(cen), jnp.asarray(rad)
    ct_, rt_ = _t(cen), _t(rad)

    def ball_j(p, si):
        return jnp.maximum(jnp.linalg.norm(p - cj_[si], axis=-1) - rj_[si],
                           0.0) ** 2

    def ball_t(p, si):
        return torch.clamp_min(torch.linalg.norm(p - ct_[si], dim=-1)
                               - rt_[si], 0.0) ** 2

    # the shape boxes are the triangles', which hold the balls' centres
    sj, dj = bvh_j.nearest_to(scene["fj"], jnp.asarray(pts), ball_j)
    st_, dt_ = nearest_to(scene["ft"], _t(pts), ball_t)
    _close(dt_, np.asarray(dj), rtol=1e-5)
    assert (_n(st_) >= 0).all()


@pytest.mark.parametrize("ascending", [True, False])
def test_ordered_walks(scene, ascending):
    """``nearest_traverse``/``farthest_traverse`` (``ordered_traverse``):
    ids, counts and order equal to the reference's, distances within rtol
    1e-6, monotone per ray."""
    rj = J.Ray.create(scene["o"], scene["d"])
    rt = T.Ray.create(scene["o"], scene["d"], device=CPU)
    fn_j = bvh_j.nearest_traverse if ascending else bvh_j.farthest_traverse
    fn_t = nearest_traverse if ascending else farthest_traverse
    ij, dj, cj = fn_j(scene["fj"], rj, max_hits=16)
    it, dt_, ct = fn_t(scene["ft"], rt, max_hits=16)
    _same(ct, cj)
    _same(it, ij)
    _close(dt_, np.asarray(dj))
    dd = _n(dt_)
    fin = np.isfinite(dd[:, 1:]) & np.isfinite(dd[:, :-1])
    step = np.where(fin, dd[:, 1:] - np.where(fin, dd[:, :-1], 0.0), 0.0)
    assert ((step >= 0) if ascending else (step <= 0))[fin].all()
    it2, _, _ = ordered_traverse(scene["ft"], rt, 16, ascending)
    assert torch.equal(it2, it)


# ---- validators -----------------------------------------------------------------

def test_flat_validators(scene):
    """``check_consistent``/``check_tight`` give [] on the port's tree (numpy
    and tensors) and the reference's messages on corrupted copies."""
    mn, mx = scene["mn"], scene["mx"]
    host = scene["ft"].to_host()
    for f in (host, scene["ft"]):
        assert check_consistent(f, mn, mx) == [] and check_tight(f) == []
    n = host.num_nodes
    corrupt = {
        "entry": host._replace(entry=np.where(host.entry >= 0,
                                              host.entry + (np.arange(n) == 0),
                                              host.entry).astype(np.int32)),
        "exit": host._replace(exit=np.where(np.arange(n) == n - 1, n - 1,
                                            host.exit).astype(np.int32)),
        "box": host._replace(aabb_min=np.where(np.arange(n)[:, None] == 2,
                                               host.aabb_min - 1.0,
                                               host.aabb_min)),
        "shape": host._replace(shape=np.where(host.shape == 1, 0,
                                              host.shape).astype(np.int32)),
    }
    for name, f in corrupt.items():
        fj = bvh_j.FlatBvh(*f)
        want = bvh_j.check_consistent(fj, mn, mx) + bvh_j.check_tight(fj)
        got = check_consistent(f, mn, mx) + check_tight(f)
        assert got == want and got, name
    with pytest.raises(AssertionError, match="BVH not tight"):
        T.bvh.assert_tight(corrupt["box"])
    assert FlatBvh.num_shapes.fget(host) == len(mn)
    assert host.ndim_space == 3 and scene["ft"].ndim_space == 3
    assert np.array_equal(host.right_child(), scene["fj"].right_child())
    assert np.array_equal(_n(scene["ft"].right_child()),
                          scene["fj"].right_child())
    assert host.pretty_print(12) == scene["fj"].pretty_print(12)


@pytest.fixture(scope="module")
def abc():
    return tb.create_n_cubes(80)


def test_scene_validators_messages(abc):
    """``check_tight_scene`` on the reference's corruptions of a host scene
    (array-equal to the reference's): the reference's messages."""
    a, b, c = abc
    sj = ops_j.build_tight_scene(a, b, c, use_native=False)
    st_ = build_tight_scene(a, b, c, use_native=False)
    sn = np.array(st_.smem_nodes)
    internal = np.nonzero(sn[6, :st_.num_nodes] >= 0)[0]
    tm = np.array(st_.tri_map)
    lanes = np.nonzero(tm >= 0)[0]
    tm[lanes[1]] = tm[lanes[0]]
    cases = []
    for row, col, val in ((3, 2, sn[0, 2] - 1.0), (7, 0, 1e9),
                          (6, internal[0], internal[0] + 2.0)):
        x = sn.copy()
        x[row, col] = val
        cases.append({"smem_nodes": x})
    cases.append({"tri_map": tm})
    gn = np.array(st_.gnodes)
    lmask = gn[7 * 16].astype(np.int64)
    k, g = next((k, g) for g in range(gn.shape[1]) for k in range(16)
                if lmask[g] >> k & 1)
    gn[7 * k, g] -= 5.0  # a leaf slot's box off its cluster's leaf box
    cases.append({"gnodes": gn})
    for kw in cases:
        for verts in ((), (a, b, c)):
            want = ops_j.check_tight_scene(sj._replace(**kw), *verts)
            got = check_tight_scene(st_._replace(**kw), *verts)
            assert got == want and got, list(kw)
    with pytest.raises(AssertionError, match="TightScene invalid"):
        assert_tight_scene(st_._replace(**cases[1]))


def test_scene_validators_pass(abc):
    """[] on the port's host, device (tensor tables), chained (host and
    device, each part) and refit scenes."""
    a, b, c = abc
    for sc in (build_tight_scene(a, b, c, use_native=False),
               build_tight_scene(a, b, c),
               build_tight_scene_device(a, b, c, device=CPU),
               build_tight_scene_device(a, b, c, upper="lbvh", device=CPU)):
        assert check_tight_scene(sc, a, b, c) == []
    for ch in (build_chained_scene(a, b, c, max_part=400, use_native=False),
               build_chained_scene_device(a, b, c, max_part=400, device=CPU)):
        for part, ids in zip(ch.parts, ch.orig_ids):
            sel = np.maximum(_n(ids), 0)
            assert check_tight_scene(part, a[sel], b[sel], c[sel]) == []
    a2, b2, c2 = (x + np.float32(0.25) for x in (a, b, c))
    re = make_refitter(build_tight_scene(a, b, c, use_native=False),
                       device=CPU)(a2, b2, c2)
    assert_tight_scene(re, a2, b2, c2)


# ---- render_hits, render_depth ---------------------------------------------------

def test_render_hits_and_depth_gradients():
    """``render_hits``/``render_depth`` over a ``FlatBvh``: forward equal to
    the reference's, and the gradients of sum(depth^2) * 1e-3 with respect
    to the vertices and the ray origins within rtol 1e-4 of the largest
    against ``jax.grad`` of the reference's loss."""
    a, b, c = tb.create_n_cubes(12)
    mn, mx = tb.tri_aabbs(a, b, c)
    flat, _ = build_sah(mn, mx)
    fj = bvh_j.build_sah(mn, mx)[0].to_device()
    ft = flat.to_device(device=CPU)
    o, d = tb.aimed_rays(a, 64, seed=4, dist=40.0)
    o2, d2 = tb.create_rays(16, seed=tb.seed_state_after(9))
    o, d = np.concatenate([o, o2]), np.concatenate([d, d2]).astype(np.float32)

    def loss_j(aa, bb, cc, oo):
        dep, _ = diff_j.render_depth(fj, J.Ray.create(oo, jnp.asarray(d)), aa,
                                     bb, cc)
        return jnp.sum(dep ** 2) * 1e-3

    gj = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (a, b, c, o)))
    hj = diff_j.render_hits(fj, J.Ray.create(o, d), *(jnp.asarray(x)
                                                      for x in (a, b, c)))
    leaves = [_t(x).requires_grad_() for x in (a, b, c, o)]
    rays = T.Ray.create(leaves[3], _t(d), device=CPU)
    ht = render_hits(ft, rays, *leaves[:3])
    _same(ht.shape_id, np.asarray(hj.shape_id))
    hit = np.asarray(hj.shape_id) >= 0
    assert hit.sum() > 40 and (~hit).any()
    _close(ht.t.detach()[hit], np.asarray(hj.t)[hit])
    dep, mask = render_depth(ft, rays, *leaves[:3])
    assert np.array_equal(_n(mask), hit)
    (torch.sum(dep ** 2) * 1e-3).backward()
    for leaf, want in zip(leaves, gj):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(_n(leaf.grad) - want).max() <= 1e-4 * scale
