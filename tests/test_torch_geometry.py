"""The port's geometry core against bvh_tpu on the same numpy inputs:
scene generation (bit-equal), rays and ray-primitive tests (masks equal,
rel 1e-6), Morton codes and the coherence sort (keys, perm and inv equal),
and the guards that keep the port free of JAX."""

import ast
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bvh_tpu
import bvh_tpu_torch
from bvh_tpu import testbase as tb_j
from bvh_tpu.bvh.lbvh import morton_codes as morton_j
from bvh_tpu.ops.trace import sort_rays_device as sort_j
from bvh_tpu_torch import testbase as tb_t
from bvh_tpu_torch.bvh.lbvh import morton_codes as morton_t
from bvh_tpu_torch.ops import make_tracer, sort_rays_device, build_tight_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"


def _rays(n=2048, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("fn,args", [
    ("create_n_cubes", (50,)),
    ("create_rays", (300,)),
    ("create_dense_mesh", (24,)),
    ("next_point3_raw_stream", (7, 100)),
    ("splitmix64_stream", (11, 64)),
])
def test_testbase_bit_equal(fn, args):
    out_j = getattr(tb_j, fn)(*args)
    out_t = getattr(tb_t, fn)(*args)
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    for x, y in zip(out_j, out_t):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8))


def test_testbase_seed_and_aabbs():
    assert tb_t.seed_state_after(10000) == tb_j.seed_state_after(10000)
    assert tb_t.seed_state_after(3, seed=5) == tb_j.seed_state_after(3, seed=5)
    o, d = tb_t.create_rays(64, seed=tb_t.seed_state_after(10))
    oj, dj = tb_j.create_rays(64, seed=tb_j.seed_state_after(10))
    assert np.array_equal(o, oj) and np.array_equal(d, dj)
    a, b, c = tb_t.create_n_cubes(20)
    for x, y in zip(tb_t.tri_aabbs(a, b, c), tb_j.tri_aabbs(a, b, c)):
        assert np.array_equal(x, y)


def test_ray_create_matches():
    o, d = _rays()
    rj = bvh_tpu.Ray.create(o, d)
    rt = bvh_tpu_torch.Ray.create(o, d, device=CPU)
    for x, y in zip(rj, rt):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-6)


def test_ray_intersects_triangle_matches():
    rng = np.random.default_rng(8)
    a, b, c = tb_t.create_n_cubes(40, bounds=(np.full(3, -20, np.float32),
                                              np.full(3, 20, np.float32)))
    n = a.shape[0]
    o = rng.uniform(-25, 25, (n, 3)).astype(np.float32)
    centers = (a + b + c) / np.float32(3)
    d = (centers + rng.normal(scale=0.3, size=(n, 3)).astype(np.float32) - o)
    rj = bvh_tpu.Ray.create(o, d)
    rt = bvh_tpu_torch.Ray.create(o, d, device=CPU)
    ij = bvh_tpu.ray_intersects_triangle(rj, jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(c))
    it = bvh_tpu_torch.ray_intersects_triangle(
        rt, torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    dj, dt = np.asarray(ij.distance), it.distance.numpy()
    assert np.isfinite(dj).sum() > n // 8
    assert (np.isfinite(dj) == np.isfinite(dt)).all()
    hit = np.isfinite(dj)
    np.testing.assert_allclose(dt[hit], dj[hit], rtol=1e-6)
    np.testing.assert_allclose(it.u.numpy()[hit], np.asarray(ij.u)[hit],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(it.v.numpy()[hit], np.asarray(ij.v)[hit],
                               rtol=1e-6, atol=1e-6)


def test_ray_aabb_tests_match():
    o, d = _rays(1024, seed=5)
    rng = np.random.default_rng(6)
    lo = rng.uniform(-40, 30, (1024, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.5, 20, (1024, 3)).astype(np.float32)
    d[:8] = [1.0, 0.0, 0.0]  # axis-parallel rays: NaN corner products
    o[:8, 1] = lo[:8, 1]  # lying in a face plane
    rj = bvh_tpu.Ray.create(o, d)
    rt = bvh_tpu_torch.Ray.create(o, d, device=CPU)
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    hj = np.asarray(bvh_tpu.ray_intersects_aabb(rj, jnp.asarray(lo), jnp.asarray(hi)))
    ht = bvh_tpu_torch.ray_intersects_aabb(rt, lo_t, hi_t).numpy()
    assert (hj == ht).all() and hj.any() and not hj.all()
    sj = bvh_tpu.intersection_slice_for_aabb(rj, jnp.asarray(lo), jnp.asarray(hi))
    st = bvh_tpu_torch.intersection_slice_for_aabb(rt, lo_t, hi_t)
    assert (np.asarray(sj[0]) == st[0].numpy()).all()
    m = np.asarray(sj[0])
    for x, y in zip(sj[1:], st[1:]):
        np.testing.assert_allclose(y.numpy()[m], np.asarray(x)[m], rtol=1e-6)


def test_morton_codes_equal():
    o, _ = _rays(4096, seed=9)
    lo, hi = o.min(axis=0), o.max(axis=0)
    mj = np.asarray(morton_j(jnp.asarray(o), jnp.asarray(lo), jnp.asarray(hi)))
    mt = morton_t(torch.from_numpy(o), torch.from_numpy(lo),
                  torch.from_numpy(hi)).numpy()
    assert mt.dtype == np.int32
    assert np.array_equal(mj, mt)


@pytest.mark.parametrize("mode", ["octant", "morton", "octmorton"])
def test_sort_rays_device_equal(mode):
    o, d = tb_t.create_rays(4096, seed=tb_t.seed_state_after(77))
    o[::7] = o[3]  # duplicate keys exercise the stable order
    pj, ij = sort_j(jnp.asarray(o), jnp.asarray(d), bits=2, mode=mode)
    pt, it = sort_rays_device(o, d, bits=2, mode=mode, device=CPU)
    pj, ij, pt, it = (np.asarray(x) for x in (pj, ij, pt, it))
    assert np.array_equal(np.sort(pt), np.arange(len(o)))
    assert np.array_equal(it[pt], np.arange(len(o)))
    if mode == "octant":
        # the reference's compiled cell scale can sit 1 ulp off the IEEE
        # quotient (XLA on the CPU), which moves origins lying on a cell
        # boundary (the farthest origin of each axis) by one cell; every
        # other ray keeps its place
        x = ((o - o.min(0)).astype(np.float64) * 3.0
             / (o.max(0) - o.min(0)).astype(np.float64))
        edge = (np.abs(x - np.round(x)) < 1e-5).any(axis=1)
        assert edge.sum() <= 8
        pj, pt = pj[~edge[pj]], pt[~edge[pt]]
        assert np.array_equal(pj, pt)
    else:
        assert np.array_equal(pj, pt)
        assert np.array_equal(ij, it)


def test_import_leaves_jax_out():
    code = ("import sys, bvh_tpu_torch, bvh_tpu_torch.ops, bvh_tpu_torch.native; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'bvh_tpu' or m.startswith('bvh_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    p.relative_to(REPO).as_posix()
    for p in list((REPO / "bvh_tpu_torch").rglob("*.py"))
    + [REPO / "chip_smoke.py", REPO / "kernel_ab.py",
       REPO / "kernel_sass.py"]))
def test_no_jax_or_bvh_tpu_import(path):
    for mod in _imports(REPO / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "bvh_tpu"), (path, mod)


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b, c = tb_t.create_n_cubes(30)
    scene = build_tight_scene(a, b, c)
    o, d = _rays(16)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_tracer(scene)
    with pytest.raises(RuntimeError, match="CUDA"):
        sort_rays_device(o, d)
    with pytest.raises(RuntimeError, match="CUDA"):
        bvh_tpu_torch.Ray.create(o, d)
    tracer = make_tracer(scene, packet=128, device=CPU)
    assert tracer(o, d).t.device.type == "cpu"
