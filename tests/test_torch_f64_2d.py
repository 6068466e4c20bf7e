"""The reference's float64, 2-D and 4-D cases (``tests/test_f64_2d.py``) on
the port's general path: the host SAH build, the validators, the flat
refit (``update_shapes``) and the batched traversals in float64 and in
D = 2 and 4, each query against the brute-force collect of both packages.

Tolerances: hit sets equal; box distances within rtol and atol 1e-5 of
numpy's; float64 closest hits within rtol 1e-12 of the port's float64
brute force, t at 2e5 coordinates within 1e-9 of the exact 50 - 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bvh_tpu as J
from bvh_tpu.bvh import brute_force_collect as brute_collect_j
from bvh_tpu.bvh import traverse as traverse_j
from bvh_tpu_torch import (Aabb, AabbQuery, Ball, BallQuery, PointQuery, Ray,
                           RayQuery)
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.bvh import (brute_force_closest_hit, brute_force_collect,
                               build_sah, check_consistent, check_tight,
                               closest_hit_triangles, nearest_to, traverse,
                               update_shapes)
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _sets(hits):
    return [set(int(s) for s in row[row >= 0]) for row in np.asarray(hits)]


def _check_queries(dev, ref, queries, mn, mx, n):
    """Each port query's hit sets equal the port's and the reference's
    brute-force collects and the reference's traverse."""
    for qt, qj in queries:
        hits, count = traverse(dev, qt, max_hits=max(n, 8))
        want = [set(np.nonzero(r)[0].tolist())
                for r in brute_force_collect(qt, _t(mn), _t(mx)).numpy()]
        want_j = [set(np.nonzero(r)[0].tolist()) for r in np.asarray(
            brute_collect_j(qj, jnp.asarray(mn), jnp.asarray(mx)))]
        got_j, _ = traverse_j(ref, qj, max_hits=max(n, 8))
        assert _sets(hits) == want == want_j == _sets(got_j), type(qt).__name__
        assert np.array_equal(count.numpy(), [len(s) for s in want])


def _grid_boxes_2d(rng, n):
    centers = rng.integers(-40, 40, size=(n, 2)).astype(np.float32) * 4.0
    half = rng.integers(1, 3, size=(n, 1)).astype(np.float32)
    return centers - half, centers + half


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_2d_grid(seed):
    """2-D boxes on an integer grid: the four queries with axis-parallel
    rays (exact), the nearest box, and a refit after moves."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 64))
    mn, mx = _grid_boxes_2d(rng, n)
    for _round in range(3):
        flat, _ = build_sah(mn, mx)
        assert flat.ndim_space == 2
        assert check_consistent(flat, mn, mx) == []
        assert check_tight(flat) == []
        dev = flat.to_device(device=CPU)
        ref = J.bvh.FlatBvh(*flat).to_device()
        o = rng.integers(-200, 200, size=(8, 2)).astype(np.float32)
        d = np.zeros((8, 2), np.float32)
        axis = rng.integers(0, 2, size=8)
        d[np.arange(8), axis] = rng.choice([-1.0, 1.0], size=8)
        r24 = np.full((8,), 24.0, np.float32)
        queries = [
            (RayQuery(Ray.create(o, d, device=CPU)),
             J.RayQuery(J.Ray.create(o, d))),
            (AabbQuery(Aabb.with_bounds(o - 16.0, o + 16.0, device=CPU)),
             J.AabbQuery(J.Aabb(jnp.asarray(o - 16.0), jnp.asarray(o + 16.0)))),
            (PointQuery(_t(o * 0.25)), J.PointQuery(jnp.asarray(o * 0.25))),
            (BallQuery(Ball.create(o * 0.5, r24, device=CPU)),
             J.BallQuery(J.Ball.create(o * 0.5, r24))),
        ]
        _check_queries(dev, ref, queries, mn, mx, n)
        mnt, mxt = _t(mn), _t(mx)

        def box_d2(pts, si):
            q = torch.clamp_min(torch.maximum(mnt[si] - pts, pts - mxt[si]),
                                0.0)
            return torch.sum(q * q, dim=-1)

        pts = rng.uniform(-150, 150, size=(8, 2)).astype(np.float32)
        _, ndist = nearest_to(dev, _t(pts), box_d2)
        qq = np.maximum(np.maximum(mn[None] - pts[:, None],
                                   pts[:, None] - mx[None]), 0.0)
        want = np.sqrt((qq * qq).sum(-1).min(axis=1))
        np.testing.assert_allclose(ndist.numpy(), want, rtol=1e-5, atol=1e-5)
        k = int(rng.integers(1, n + 1))
        moved = rng.choice(n, size=k, replace=False)
        delta = rng.integers(-10, 10, size=(k, 2)).astype(np.float32) * 4.0
        mn, mx = mn.copy(), mx.copy()
        mn[moved] += delta
        mx[moved] += delta
        refitted = update_shapes(dev, _t(mn), _t(mx))
        assert check_consistent(refitted, mn, mx) == []
        assert check_tight(refitted) == []


def test_f64_build_and_closest_hit():
    """Float64 end to end: the tree, the slab tests and Moller-Trumbore
    resolve two triangles 1e-9 apart at 2e5, and random rays agree with
    float64 brute force at rtol 1e-12."""
    rng = np.random.default_rng(7)
    a32, b32, c32 = tb.create_n_cubes(40)
    a, b, c = (x.astype(np.float64) for x in (a32, b32, c32))
    base = np.array([[0.0, 0.0, 0.0], [0.0, 4.0, 0.0], [0.0, 0.0, 4.0]])
    eps9 = 1e-9
    a = np.concatenate([a, [base[0] + [2e5, 0, 0]], [base[0] + [2e5 + eps9, 0, 0]]])
    b = np.concatenate([b, [base[1] + [2e5, 0, 0]], [base[1] + [2e5 + eps9, 0, 0]]])
    c = np.concatenate([c, [base[2] + [2e5, 0, 0]], [base[2] + [2e5 + eps9, 0, 0]]])
    mn, mx = tb.tri_aabbs(a, b, c)
    assert mn.dtype == np.float64
    flat, _ = build_sah(mn, mx)
    assert flat.aabb_min.dtype == np.float64
    assert check_consistent(flat, mn, mx) == [] and check_tight(flat) == []
    dev = flat.to_device(device=CPU)
    at, bt, ct = (_t(x) for x in (a, b, c))
    o = np.array([[2e5 + 50.0, 1.0, 1.0]] * 2)
    d = np.array([[-1.0, 0.0, 0.0]] * 2)
    rays = Ray.create(o, d, device=CPU)
    assert rays.origin.dtype == torch.float64
    got = closest_hit_triangles(dev, rays, at, bt, ct)
    assert got.t.dtype == torch.float64
    assert int(got.shape_id[0]) == a.shape[0] - 1  # the nearer by 1e-9
    assert abs(float(got.t[0]) - (50.0 - eps9)) < 1e-9
    o = rng.uniform(-500, 500, size=(16, 3))
    centers = a[: 40 * 12].reshape(-1, 12, 3).mean(axis=1)
    d = centers[rng.integers(0, 40, size=16)] + 0.1 - o
    rays = Ray.create(o, d, device=CPU)
    got = closest_hit_triangles(dev, rays, at, bt, ct)
    want = brute_force_closest_hit(rays, at, bt, ct)
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), rtol=1e-12)
    with jax.enable_x64(True):
        want_j = J.bvh.brute_force_closest_hit(
            J.Ray.create(jnp.asarray(o), jnp.asarray(d)), *(jnp.asarray(x)
                                                            for x in (a, b, c)))
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want_j.t),
                                   rtol=1e-12)
    shift = np.float64(1e-7)
    refitted = update_shapes(dev, _t(mn + shift), _t(mx + shift))
    assert refitted.aabb_min.dtype == torch.float64
    assert check_consistent(refitted, mn + shift, mx + shift) == []
    assert check_tight(refitted) == []


def test_trace_kernels_refuse_f64_rays():
    """The CUDA trace entry points take float32 rays and raise on float64
    ones instead of casting them."""
    from bvh_tpu_torch.ops import build_tight_scene, trace_closest_hit_tight
    a, b, c = tb.create_n_cubes(4)
    scene = build_tight_scene(a, b, c)
    rays = Ray.create(np.zeros((4, 3)), np.ones((4, 3)), device=CPU)
    with pytest.raises(ValueError, match="float32"):
        trace_closest_hit_tight(scene, rays, device=CPU)
    r32 = Ray.create(np.zeros((4, 3), np.float32), np.ones((4, 3)),
                     dtype=torch.float32, device=CPU)
    assert r32.origin.dtype == torch.float32
    trace_closest_hit_tight(scene, r32, device=CPU)


def test_4d_build_and_queries():
    """D = 4: the build, the validators and three queries."""
    rng = np.random.default_rng(11)
    n = 64
    centers = rng.uniform(-50, 50, size=(n, 4)).astype(np.float32)
    half = rng.uniform(0.5, 3.0, size=(n, 1)).astype(np.float32)
    mn, mx = centers - half, centers + half
    flat, _ = build_sah(mn, mx)
    assert flat.ndim_space == 4
    assert check_consistent(flat, mn, mx) == [] and check_tight(flat) == []
    dev = flat.to_device(device=CPU)
    ref = J.bvh.FlatBvh(*flat).to_device()
    pts = rng.uniform(-60, 60, size=(8, 4)).astype(np.float32)
    r15 = np.full((8,), 15.0, np.float32)
    queries = [
        (PointQuery(_t(pts)), J.PointQuery(jnp.asarray(pts))),
        (AabbQuery(Aabb.with_bounds(pts - 10.0, pts + 10.0, device=CPU)),
         J.AabbQuery(J.Aabb(jnp.asarray(pts - 10.0), jnp.asarray(pts + 10.0)))),
        (BallQuery(Ball.create(pts, r15, device=CPU)),
         J.BallQuery(J.Ball.create(pts, r15))),
    ]
    _check_queries(dev, ref, queries, mn, mx, n)
