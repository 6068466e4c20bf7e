"""Differentiable rendering (``bvh_tpu_torch.diff``) against
``bvh_tpu.diff`` and against finite differences.

On create_n_cubes(120) with 1,024 aimed rays (each hits) and 256
reference-random rays (most miss), the same float32 ray tensors go to both:

* ``render_depth_fast``: hit masks equal to the reference's (its Pallas
  hard pass in interpret mode, reciprocal made exact) but for the
  reference's grazing-edge class: on a few rays (3 here, at most 1%) 6e-4
  of a unit or less inside a cube's edge, the reference's leaf test, whose
  forms lose ~0.01 of a unit at 1e5 (ROADMAP queue 3, item 3), takes the
  neighbouring triangle, which its exact recompute rejects, so it reports
  a miss; the port hits there at brute force's distance. Elsewhere depth
  within DEPTH_RTOL of the reference's: both recompute the winner with the
  same float32 Moller-Trumbore, the port with every product rounded on its
  own, XLA free to fuse them.
* The gradients of bench.py's loss, sum over hits of (depth - target)^2,
  over the rays both hit, with respect to a, b, c and the ray origins:
  within GRAD_RTOL of ``jax.grad`` of the reference's, relative to the
  largest entry of each (the scatter-adds into the vertex tables sum a
  triangle's rays in another order). Miss lanes and triangles no ray hits
  get exactly 0.
* float64 finite differences (``torch.autograd.gradcheck``) of the depth of
  a few rays with respect to their triangles' vertices and their origins:
  the walk stays float32, the recompute runs in float64.
* ``camera_rays``: origins equal to the reference's, directions within
  CAMERA_ATOL; the gradient of the directions with respect to the eye
  within GRAD_RTOL of ``jax.grad``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bvh_tpu
from bvh_tpu.diff import camera_rays as camera_rays_j
from bvh_tpu.diff import render_depth_fast as render_depth_fast_j
from bvh_tpu.ops.cluster import build_tight_scene as build_j
from bvh_tpu_torch import Ray, ray_intersects_triangle
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.diff import camera_rays, render_depth_fast, render_hits_fast
from bvh_tpu_torch.ops import build_tight_scene
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
N_CUBES = 120
PACKET = 512
DEPTH_RTOL = 8 * 2.0 ** -23  # a few float32 ulps
GRAD_RTOL = 1e-5
CAMERA_ATOL = 4 * 2.0 ** -23


@pytest.fixture(scope="module")
def world():
    a, b, c = tb.create_n_cubes(N_CUBES)
    o1, d1 = tb.aimed_rays(a, 1024, seed=2)
    o2, d2 = tb.create_rays(256, seed=tb.seed_state_after(N_CUBES))
    o = np.concatenate([o1, o2])
    d = np.concatenate([d1, d2])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    target = np.random.default_rng(4).uniform(30.0, 60.0, len(o))
    return (a, b, c), o, d, target.astype(np.float32)


def _loss_j(sj, o, d, target, start_g):
    inv = 1.0 / jnp.asarray(d)

    def loss(a, b, c, oo):
        rays = bvh_tpu.Ray(oo, jnp.asarray(d), inv)
        depth, hit = render_depth_fast_j(sj, rays, a, b, c, packet=PACKET,
                                         interpret=True, start_g=start_g)
        return jnp.sum(jnp.where(hit, (depth - target) ** 2, 0.0)), (depth, hit)

    return loss


@pytest.fixture(scope="module")
def reference(world):
    """The reference's depth, hits and gradients, its reciprocal made exact
    (compiled traces dropped before and after, so the patch does not
    leak)."""
    tris, o, d, target = world
    sj = build_j(*tris)
    with pytest.MonkeyPatch.context() as mp:
        jax.clear_caches()
        mp.setattr(pl, "reciprocal", lambda x, approx=False: 1.0 / x)
        fn = jax.value_and_grad(_loss_j(sj, o, d, target, None),
                                argnums=(0, 1, 2, 3), has_aux=True)
        (val, (depth, hit)), grads = fn(*(jnp.asarray(x) for x in tris),
                                        jnp.asarray(o))
        out = (float(val), np.asarray(depth), np.asarray(hit),
               [np.asarray(g) for g in grads])
    jax.clear_caches()
    return out


def _port_loss(st, tris, o, d, target, keep, **kw):
    """The loss over the hits of the rays ``keep``, its depth, hits and
    gradients."""
    a, b, c, oo = (torch.from_numpy(x).requires_grad_() for x in (*tris, o))
    dd = torch.from_numpy(d)
    rays = Ray(oo, dd, 1.0 / dd)
    depth, hit = render_depth_fast(st, rays, a, b, c, packet=PACKET,
                                   device=CPU, **kw)
    loss = torch.where(hit & torch.tensor(keep),
                       (depth - torch.from_numpy(target)) ** 2, 0.0).sum()
    loss.backward()
    return loss, depth, hit, [x.grad for x in (a, b, c, oo)]


@pytest.mark.parametrize("entries", [None, "random"])
def test_depth_and_gradients_match_reference(world, reference, entries):
    """With and without subtree entries in the hard pass (which change no
    hit)."""
    tris, o, d, target = world
    st = build_tight_scene(*tris)
    kw = {}
    if entries == "random":
        p = -(-len(o) // PACKET)
        kw["start_g"] = np.random.default_rng(3).integers(
            -1, st.gnodes.shape[1], (p, 2))
    val_j, depth_j, hit_j, grads_j = reference
    loss, depth, hit, grads = _port_loss(st, tris, o, d, target, hit_j, **kw)
    hit, depth = hit.numpy(), depth.detach().numpy()
    assert 0.75 < hit_j.mean() < 0.85  # every aimed ray, few random ones
    # the reference's grazing-edge misses: the port hits at brute force's t
    extra = hit & ~hit_j
    assert not (hit_j & ~hit).any() and extra.sum() <= len(o) // 100
    rays_x = Ray(*(torch.from_numpy(x[extra])[:, None] for x in
                   (o, d, 1.0 / d)))
    t_bf = ray_intersects_triangle(rays_x, *(torch.from_numpy(x)[None]
                                             for x in tris))
    np.testing.assert_allclose(depth[extra],
                               t_bf.distance.amin(dim=1).numpy(), rtol=1e-5)
    np.testing.assert_allclose(depth[hit_j], depth_j[hit_j], rtol=DEPTH_RTOL)
    assert float(loss.detach()) == pytest.approx(val_j, rel=1e-5)
    for g, gj in zip(grads, grads_j):
        g = g.numpy()
        assert np.isfinite(g).all()
        scale = np.abs(gj).max()
        assert scale > 0
        np.testing.assert_allclose(g, gj, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale)
    # miss lanes and unhit triangles get exactly 0
    go = grads[3].numpy()
    assert (go[~hit_j] == 0).all() and (np.abs(go[hit_j]).sum(1) > 0).all()
    sid = render_hits_fast(st, Ray(*(torch.from_numpy(x) for x in
                                     (o, d, 1.0 / d))),
                           *(torch.from_numpy(x) for x in tris),
                           packet=PACKET, device=CPU).shape_id.numpy()[hit_j]
    unhit = np.setdiff1d(np.arange(len(tris[0])), sid[sid >= 0])
    for g in grads[:3]:
        assert (g.numpy()[unhit] == 0).all()


def test_gradients_match_finite_differences(world):
    """float64 finite differences of the depth of six hit rays with respect
    to their triangles' vertices and their origins."""
    tris, o, d, _ = world
    st = build_tight_scene(*tris)
    idx = np.array([0, 100, 257, 511, 700, 1023])
    o6, d6 = (torch.from_numpy(x[idx]).double() for x in (o, d))
    t64 = [torch.from_numpy(x).double() for x in tris]
    sid = render_hits_fast(st, Ray(o6, d6, 1.0 / d6), *t64, packet=128,
                           device=CPU).shape_id
    assert (sid >= 0).all()
    rows = sid.to(torch.int64)

    def depth(a_rows, b_rows, c_rows, origins):
        a, b, c = (t.index_put((rows,), r) for t, r in
                   zip(t64, (a_rows, b_rows, c_rows)))
        dep, hit = render_depth_fast(st, Ray(origins, d6, 1.0 / d6), a, b, c,
                                     packet=128, device=CPU)
        assert hit.all()
        return dep

    inputs = tuple(x.clone().requires_grad_() for x in
                   (t64[0][rows], t64[1][rows], t64[2][rows], o6))
    assert torch.autograd.gradcheck(depth, inputs, eps=1e-4, atol=1e-6,
                                    rtol=1e-5)


def test_camera_rays_match_reference():
    eye = np.array([3.0, 40.0, -90.0], np.float32)
    look, up = np.array([1.0, 2.0, 3.0], np.float32), np.array([0.0, 1.0, 0.0])
    got = camera_rays(eye, look, up, 45.0, 32, 24, device=CPU)
    ref = camera_rays_j(eye, look, up, 45.0, 32, 24)
    assert np.array_equal(got.origin.numpy(), np.asarray(ref.origin))
    np.testing.assert_allclose(got.direction.numpy(), np.asarray(ref.direction),
                               atol=CAMERA_ATOL, rtol=0)
    # the directions' gradient with respect to the eye
    w = np.random.default_rng(1).normal(size=(32 * 24, 3)).astype(np.float32)
    e = torch.from_numpy(eye).requires_grad_()
    (camera_rays(e, look, up, 45.0, 32, 24, device=CPU).direction
     * torch.from_numpy(w)).sum().backward()
    gj = jax.grad(lambda x: jnp.sum(
        camera_rays_j(x, look, up, 45.0, 32, 24).direction * w))(
        jnp.asarray(eye))
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(gj), rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(gj).max())
