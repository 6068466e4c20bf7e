"""The port's path tracer (``bvh_tpu_torch/render.py``) against
``bvh_tpu.render.make_pathtracer`` (Pallas in interpret mode) on a
3,042-triangle dense mesh, a 32x32 camera of the reference bench's pose,
``packet=128``.

Both packages get the same bounce noise: the port's draw
(``render.bounce_noise``) and ``jax.random.normal`` are patched, in this
test only, to return the same [npx, 3] normals made with numpy.

Tolerance: colours within 1e-4 relative plus 1e-5 absolute on all but 1% of
the pixels. The rest are the trace's documented classes: a hit on a shared
edge may take the adjacent triangle's normal (grazing edge), and a shadow
ray whose occluder lies within the key truncation (and, in the reference,
its approximate reciprocal) of t_max may fall on either side. Every colour
is finite and non-negative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.ops.cluster import build_tight_scene as build_j
from bvh_tpu.render import make_pathtracer as make_pathtracer_j
from bvh_tpu_torch import render
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import build_tight_scene
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
SIDE = 32


def _camera(side):
    """The reference bench's camera (bench.py:615-650) at side x side."""
    eye = np.array([0.0, 60.0, -120.0], np.float32)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0]).astype(np.float32)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    tan_half = np.float32(np.tan(np.deg2rad(55.0) * 0.5))
    xs = (np.arange(side, dtype=np.float32) + 0.5) / side * 2.0 - 1.0
    px, py = np.meshgrid(xs * tan_half, -xs * tan_half, indexing="xy")
    d = (fwd + px[..., None] * right + py[..., None] * up).reshape(-1, 3)
    return np.broadcast_to(eye, d.shape).astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def mesh():
    tris = tb.create_dense_mesh(40)
    o, d = _camera(SIDE)
    return tris, o, d


def _render_both(mesh, bounces, monkeypatch):
    tris, o, d = mesh
    noise = np.random.default_rng(9).normal(
        size=(bounces + 1, len(o), 3)).astype(np.float32)
    draws = iter(range(bounces + 1))
    monkeypatch.setattr(render, "bounce_noise",
                        lambda npx, gen, dev: torch.from_numpy(
                            noise[next(draws)]).to(dev))
    jdraws = iter(range(bounces + 1))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(
                            noise[next(jdraws)]))
    kw = dict(bounces=bounces, packet=128, light_pos=(40.0, 80.0, -40.0),
              light_power=20000.0)
    ref = make_pathtracer_j(build_j(*tris), tris, interpret=True, **kw)(
        jnp.asarray(o), jnp.asarray(d), jax.random.key(0))
    got = render.make_pathtracer(build_tight_scene(*tris), tris, device=CPU,
                                 **kw)(o, d, torch.Generator().manual_seed(0))
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("bounces", [0, 1])
def test_pathtracer_matches_reference(mesh, bounces, monkeypatch):
    ref, got = _render_both(mesh, bounces, monkeypatch)
    assert got.shape == (SIDE * SIDE, 3) and got.dtype == np.float32
    assert np.isfinite(got).all() and (got >= 0).all()
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    # the image is lit, shadowed and has sky
    lum = got.sum(axis=1)
    assert lum.max() > 1.0 and (lum < 0.5 * np.median(lum)).any()


def test_pathtracer_noise_and_generator(mesh):
    """The port draws the bounces from the caller's generator: one seed gives
    one image, another seed another."""
    tris, o, d = mesh
    trace = render.make_pathtracer(build_tight_scene(*tris), tris, bounces=1,
                                   packet=128, device=CPU)
    a = trace(o, d, torch.Generator().manual_seed(1))
    b = trace(o, d, torch.Generator().manual_seed(1))
    c = trace(o, d, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    n = render.bounce_noise(1000, torch.Generator().manual_seed(0), CPU)
    assert n.shape == (1000, 3) and abs(float(n.std()) - 1.0) < 0.1
