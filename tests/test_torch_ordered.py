"""The port's depth-peeled k-closest hits (trace_k_closest on a tight scene,
trace_k_closest_chained on a chained one) against bvh_tpu (Pallas in
interpret mode) and an all-hits brute-force oracle, on the reference's
stacked-cube scene (tests/test_k_closest.py): 60 cubes along +z, 256 rays
along z that cross several of them.

Tolerances:

* Against the reference with its reciprocal made exact
  (``exact_reciprocal``): the same hit count per ray and the same shape ids
  in every slot, t within rtol 1e-5 (each pass moves the origins by the
  pass's raw t, which the two packages round one key step apart at most).
* Against the oracle: the reference's own bounds (tests/test_k_closest.py):
  the oracle's front-facing hits outside the peel-epsilon merge class
  (ordered.py:19-25), t within rtol 5e-3, at most one hit fewer than the
  oracle, ascending in every row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bvh_tpu
from bvh_tpu.ops import build_chained_scene as build_chained_j
from bvh_tpu.ops import build_tight_scene as build_j
from bvh_tpu.ops import trace_k_closest as k_closest_j
from bvh_tpu.ops import trace_k_closest_chained as k_closest_chained_j
from bvh_tpu_torch import Ray, ray_intersects_triangle
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import (build_chained_scene, build_tight_scene,
                               trace_k_closest, trace_k_closest_chained)
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
PACKET = 128


@pytest.fixture(scope="module")
def stacked():
    """Cubes stacked along +z so straight rays cross several of them."""
    rng = np.random.default_rng(71)
    a, b, c = (x.copy() for x in tb.create_n_cubes(60))
    for i in range(60):
        sl = slice(12 * i, 12 * (i + 1))
        ctr = (a[sl] + b[sl] + c[sl]).mean(axis=0) / 3.0
        new = np.array([rng.uniform(-1.5, 1.5), rng.uniform(-1.5, 1.5),
                        8.0 * i], np.float32)
        for arr in (a, b, c):
            arr[sl] += new - ctr
    n = 256
    o = np.concatenate([rng.uniform(-1, 1, (n, 2)), np.full((n, 1), -30.0)],
                       axis=1).astype(np.float32)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    d[:, :2] = rng.normal(scale=0.01, size=(n, 2))
    return (a, b, c), o, d


@pytest.fixture
def exact_reciprocal(monkeypatch):
    """The reference's approximate reciprocal (bfloat16 in interpret mode)
    made exact for one test; compiled traces are dropped before and after."""
    jax.clear_caches()
    monkeypatch.setattr(pl, "reciprocal", lambda x, approx=False: 1.0 / x)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _oracle(o, d, tris):
    """[R, n] ascending front-facing hit distances (inf-padded)."""
    rays = Ray.create(o, d, device=CPU)
    a_, b_, c_ = (torch.from_numpy(x)[None] for x in tris)
    t = ray_intersects_triangle(Ray(*(x[:, None] for x in rays)), a_, b_,
                                c_).distance.numpy()
    return np.sort(t, axis=1)


def _assert_matches_oracle(t, count, o, d, tris, k):
    bt = _oracle(o, d, tris)
    assert (count > 1).any()  # the workload crosses several surfaces
    for i in range(len(o)):
        keep = []
        for tv in bt[i][np.isfinite(bt[i])]:
            # oracle hits inside the eps-merge window of their predecessor
            if not keep or tv > keep[-1] * (1 + 2e-4) + 2e-6:
                keep.append(tv)
        want = np.asarray(keep[:k], np.float32)
        got = t[i][np.isfinite(t[i])]
        assert len(got) >= min(len(want), k) - 1, (i, got, want)
        m = min(len(got), len(want))
        np.testing.assert_allclose(got[:m], want[:m], rtol=5e-3,
                                   err_msg=str(i))
        assert (np.diff(got) > 0).all(), i


def _assert_matches_reference(ref, got):
    t_r, s_r, c_r = (np.asarray(x) for x in ref)
    t_g, s_g, c_g = (x.numpy() for x in got)
    assert t_g.dtype == np.float32 and s_g.dtype == np.int32
    assert c_g.dtype == np.int32
    assert np.array_equal(c_g, c_r)
    assert np.array_equal(s_g, s_r)
    fin = np.isfinite(t_r)
    assert np.array_equal(np.isfinite(t_g), fin)
    np.testing.assert_allclose(t_g[fin], t_r[fin], rtol=1e-5)


@pytest.mark.parametrize("with_tris", [False, True])
def test_k_closest_matches_reference(stacked, with_tris, exact_reciprocal):
    tris, o, d = stacked
    k = 5
    ref = k_closest_j(build_j(*tris), bvh_tpu.Ray.create(o, d), k=k,
                      packet=PACKET, interpret=True,
                      tris=tuple(jnp.asarray(x) for x in tris)
                      if with_tris else None)
    got = trace_k_closest(build_tight_scene(*tris),
                          Ray.create(o, d, device=CPU), k=k, packet=PACKET,
                          tris=tris if with_tris else None, device=CPU)
    _assert_matches_reference(ref, got)
    _assert_matches_oracle(got[0].numpy(), got[2].numpy(), o, d, tris, k)


def test_k_closest_chained_matches_reference(stacked, exact_reciprocal):
    tris, o, d = stacked
    k = 3
    cj = build_chained_j(*tris, max_part=300)
    ct = build_chained_scene(*tris, max_part=300)
    assert len(ct.parts) >= 2
    ref = k_closest_chained_j(cj, bvh_tpu.Ray.create(o, d), k=k,
                              packet=PACKET, interpret=True)
    got = trace_k_closest_chained(ct, Ray.create(o, d, device=CPU), k=k,
                                  packet=PACKET, device=CPU)
    _assert_matches_reference(ref, got)
    _assert_matches_oracle(got[0].numpy(), got[2].numpy(), o, d, tris, k)
    # the chain agrees with one scene of the whole set (the reference's
    # test_k_closest_chained bound)
    t1 = trace_k_closest(build_tight_scene(*tris),
                         Ray.create(o, d, device=CPU), k=k, packet=PACKET,
                         device=CPU)[0].numpy()
    t2 = got[0].numpy()
    m = np.isfinite(t1) & np.isfinite(t2)
    assert (np.isfinite(t1) == np.isfinite(t2)).mean() > 0.99
    np.testing.assert_allclose(t1[m], t2[m], rtol=1e-2)


def test_k_closest_misses_and_empty():
    a, b, c = tb.create_n_cubes(10)
    scene = build_tight_scene(a, b, c)
    o = np.full((64, 3), 5e4, np.float32)
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (64, 1))
    t, sid, count = trace_k_closest(scene, Ray.create(o, d, device=CPU), k=3,
                                    device=CPU)
    assert t.shape == (64, 3) and not torch.isfinite(t).any()
    assert (sid == -1).all() and (count == 0).all()
    z = np.zeros((0, 3), np.float32)
    for fn, sc in ((trace_k_closest, scene),
                   (trace_k_closest_chained, build_chained_scene(a, b, c))):
        t, sid, count = fn(sc, Ray.create(z, z, device=CPU), k=2, device=CPU)
        assert t.shape == (0, 2) and sid.shape == (0, 2) and count.shape == (0,)
