"""The twins of ``examples/`` (``bvh_tpu_torch.examples``) against the
originals and ``bvh_tpu``, and the slab count's plain version against
bench.py's ``slab_all``, on the CPU.

* ``generate_colonnade_obj`` writes the original's text byte for byte; the
  path tracer's ``make_scene`` and ``camera_rays`` give the original's
  arrays exactly; the dynamic loop's rays, per-frame moved sets and shifts
  are the original's numpy sequence (restated here from
  ``examples/dynamic_scene.py``), so its final vertices are equal.
* The camera twin on ``create_dense_mesh(res=40)`` (W=128) at 32x32 against
  ``bvh_tpu.ops.make_tracer(sort=None)`` in interpret mode (its reciprocal
  made exact) on the twin's own tile-major rays: hit masks equal, t within
  ``T_RTOL`` relative (the reference's key t against the port's, both
  truncated to the lane bits), shape ids equal outside the near-tie and
  grazing-edge classes (``test_torch_chained.assert_tie_class``); the free
  tracer with ``plan="key"`` bit-equal to it without (the twin's check).
* The OBJ twin at 32x32 against ``bvh_tpu.diff.render_depth_fast`` and
  ``jax.value_and_grad`` of the same loss on the same colonnade: loss
  within ``LOSS_RTOL``, |grad| within ``GRAD_RTOL`` (the two packages'
  camera directions differ in the last bits, and the scatter-adds sum a
  triangle's rays in another order).
* Each twin's ``main`` with ``--cpu`` at small sizes runs to its end with
  its own checks true and writes its image; without ``--cpu`` and without
  a card it raises.
* The plain slab count equals ``slab_all`` (restated with ``jnp``) exactly
  on 4,096 of the ray_aabb_1000 leg's rays x its 1,000 boxes, with rays in
  a box's face plane among them.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bvh_tpu
from bvh_tpu.diff import render_depth_fast as render_depth_fast_j
from bvh_tpu.diff.camera import camera_rays as camera_rays_j
from bvh_tpu.io.obj import load_obj_triangles as load_obj_j
from bvh_tpu.ops import build_tight_scene as build_j
from bvh_tpu.ops import make_tracer as make_tracer_j
from bvh_tpu_torch import Ray
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.examples import (camera_tracer, dynamic_scene,
                                    nearest_query, obj_render, pathtrace)
from bvh_tpu_torch.ops import slab as slab_mod
from test_torch_chained import assert_tie_class, exact_reciprocal  # noqa: F401
from test_torch_scene import reference_native  # noqa: F401  (autouse)

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
T_RTOL = 2e-4
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
TWINS = {"camera_tracer": camera_tracer, "dynamic_scene": dynamic_scene,
         "nearest_query": nearest_query, "obj_render": obj_render,
         "pathtrace": pathtrace}
# small sizes for the CPU; the twins cap dynamic, nearest, obj and
# pathtrace themselves under --cpu
CPU_ARGS = {"camera_tracer": ["--size", "32", "--res", "40"],
            "dynamic_scene": [], "nearest_query": [],
            "obj_render": ["--size", "32"], "pathtrace": ["--size", "32"]}
IMAGES = ("camera_tracer", "obj_render", "pathtrace")


def original(name: str):
    """The module ``examples/<name>.py`` under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        f"original_{name}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_cols", [4, 8])
def test_colonnade_text_equals_original(tmp_path, n_cols):
    ref, got = tmp_path / "ref.obj", tmp_path / "got.obj"
    original("obj_render").generate_colonnade_obj(str(ref), n_cols=n_cols)
    obj_render.generate_colonnade_obj(str(got), n_cols=n_cols)
    assert got.read_bytes() == ref.read_bytes()


def test_pathtrace_scene_and_camera_equal_original():
    ref = original("pathtrace")
    for x, y in zip(pathtrace.make_scene(), ref.make_scene()):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for x, y in zip(pathtrace.camera_rays(64), ref.camera_rays(64)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_dynamic_sequence_equals_original(tmp_path):
    """Rays, moved sets and shifts of 3 frames at 150 cubes: the original's
    draws (examples/dynamic_scene.py, the rays and the frame loop)."""
    res = dynamic_scene.main(["--cpu", "--cubes", "150", "--frames", "3"])
    a, b, c = (np.asarray(x) for x in bvh_tpu.testbase.create_n_cubes(150))
    n, rays = a.shape[0], 1 << 12
    per_frame = max(int(n * 0.02), 12)
    centers = a.reshape(-1, 12, 3).mean(axis=1)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(centers), rays)
    offs = rng.normal(size=(rays, 3)).astype(np.float32)
    offs /= np.linalg.norm(offs, axis=1, keepdims=True)
    o = (centers[idx] + offs * 45.0).astype(np.float32)
    d = (centers[idx] + 0.1 - o).astype(np.float32)
    moved_all = np.full(per_frame * 3, -1, np.int32)
    a2, b2, c2 = a.copy(), b.copy(), c.copy()
    for frame in range(3):
        mv = rng.choice(n, size=per_frame, replace=False).astype(np.int32)
        shift = rng.uniform(5, 25, size=(1, 3)).astype(np.float32)
        for arr in (a2, b2, c2):
            arr[mv] += shift
        moved_all[frame * per_frame:(frame + 1) * per_frame] = mv
    out = res["outputs"]
    assert np.array_equal(out["o"], o) and np.array_equal(out["d"], d)
    assert np.array_equal(out["moved"], moved_all)
    for x, y in zip(out["tris"], (a2, b2, c2)):
        assert np.array_equal(x, y)
    assert res["agree"] > dynamic_scene.AGREE_MIN


def test_camera_twin_matches_reference(tmp_path, exact_reciprocal):
    res = camera_tracer.main(["--cpu", "--size", "32", "--res", "40",
                              "--out", str(tmp_path / "depth.pgm")])
    assert res["plan_equal"] and res["width"] == 128
    out = res["outputs"]
    a, b, c = tb.create_dense_mesh(40)
    ref = make_tracer_j(build_j(a, b, c, leaf_size=128), packet=1024,
                        sweep=False, sort=None, interpret=True)(
        jnp.asarray(out["o"]), jnp.asarray(out["d"]))
    t_r, s_r = np.asarray(ref.t), np.asarray(ref.shape_id)
    t_g, s_g = out["t"], out["shape_id"]
    hit = np.isfinite(t_r)
    assert 0.5 < hit.mean() < 0.9
    assert np.array_equal(np.isfinite(t_g), hit)
    np.testing.assert_allclose(t_g[hit], t_r[hit], rtol=T_RTOL)
    assert_tie_class((t_r, s_r), (t_g, s_g), 128)


def test_obj_twin_matches_reference(tmp_path, exact_reciprocal):
    res = obj_render.main(["--cpu", "--size", "32",
                           "--out", str(tmp_path / "obj.pgm")])
    path = str(tmp_path / "colonnade.obj")
    original("obj_render").generate_colonnade_obj(path)
    a, b, c = load_obj_j(path)
    scene = build_j(a, b, c)
    cam = camera_rays_j(np.float32([0.0, 9.0, 16.0]),
                        np.float32([0.0, 2.5, 0.0]),
                        np.float32([0.0, 1.0, 0.0]), 55.0, 32, 32)
    tris = tuple(jnp.asarray(x) for x in (a, b, c))

    def render(av, bv, cv):
        return render_depth_fast_j(scene, cam, av, bv, cv, background=40.0,
                                   packet=2048, interpret=True)

    depth, hit = render(*tris)
    target = jnp.where(hit, depth - 0.1, depth)

    def loss(av, bv, cv):
        d, h = render(av, bv, cv)
        return jnp.sum(jnp.where(h, (d - target) ** 2, 0.0))

    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(*tris)
    gnorm = float(sum(jnp.sum(g * g) for g in grads)) ** 0.5
    assert res["hit_fraction"] == pytest.approx(float(hit.mean()), abs=1e-3)
    assert res["loss"] == pytest.approx(float(val), rel=LOSS_RTOL)
    assert res["grad_norm"] == pytest.approx(gnorm, rel=GRAD_RTOL)


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_runs_on_cpu(tmp_path, name):
    argv = ["--cpu"] + CPU_ARGS[name]
    if name in IMAGES:
        argv += ["--out", str(tmp_path / "img")]
    res = TWINS[name].main(argv)
    assert res["device"] == "cpu"
    checks = {"camera_tracer": ("plan_equal",), "dynamic_scene": (),
              "nearest_query": ("brute_ok", "general_ok"),
              "obj_render": ("finite",),
              "pathtrace": ("finite", "non_negative")}
    assert all(res[k] for k in checks[name])
    if name == "dynamic_scene":
        assert res["agree"] > dynamic_scene.AGREE_MIN
    if name == "obj_render":
        assert res["grad_norm"] > 0 and res["hit_fraction"] > 0.5
    if name == "pathtrace":
        assert 0 < res["mean_luminance"] < 1
    if name in IMAGES:
        data = (tmp_path / "img").read_bytes()
        magic = b"P6" if name == "pathtrace" else b"P5"
        side = res["size"]
        header = magic + f"\n{side} {side}\n255\n".encode()
        assert data.startswith(header)
        depth = 3 if name == "pathtrace" else 1
        assert len(data) == len(header) + side * side * depth


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_without_card_raises(monkeypatch, tmp_path, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = CPU_ARGS[name] + (["--out", str(tmp_path / "img")]
                             if name in IMAGES else [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TWINS[name].main(argv)
    assert not (tmp_path / "img").exists()


def test_slab_count_plain_equals_bench_formula():
    """bench.py's ray_aabb_1000 inputs (4,096 of its rays, half aimed at box
    centres, and its 1,000 boxes) with 64 rays in a box's face plane."""
    a, b, c = tb.create_n_cubes(84)
    mn, mx = tb.tri_aabbs(a[:1000], b[:1000], c[:1000])
    n = 1 << 17
    o, d = tb.create_rays(n, seed=tb.seed_state_after(84))
    ctr = ((mn + mx) * 0.5)[np.arange(n // 2) % 1000]
    d = d.copy()
    d[:n // 2] = ctr - o[:n // 2]
    d[:n // 2] /= np.linalg.norm(d[:n // 2], axis=1, keepdims=True)
    keep = np.r_[0:2048, n - 2048:n]
    o, d = o[keep], d[keep]
    k = np.arange(64)
    o[k] = (mn[k] + mx[k]) * 0.5
    o[k, 0] = mn[k, 0]
    o[k, 2] -= 10.0
    d[k] = (0.0, 0.0, 1.0)
    rays = Ray.create(o, d, device="cpu")
    # slab_all on the same float32 origins and inverse directions
    o_j, inv_j = jnp.asarray(rays.origin), jnp.asarray(rays.inv_direction)
    mn_j, mx_j = jnp.asarray(mn), jnp.asarray(mx)
    t1 = (mn_j[None] - o_j[:, None]) * inv_j[:, None]
    t2 = (mx_j[None] - o_j[:, None]) * inv_j[:, None]
    tmin = jnp.minimum(t1, t2).max(axis=-1)
    tmax = jnp.maximum(t1, t2).min(axis=-1)
    hit = np.asarray(tmax >= jnp.maximum(tmin, 0.0))
    assert not hit[k, k].any()  # each face-plane ray misses its own box
    assert hit.sum() > 2048  # the aimed half hits
    args = (rays.origin, rays.inv_direction, torch.from_numpy(mn),
            torch.from_numpy(mx))
    got = slab_mod.slab_count_plain(*args, chunk=1 << 18)
    assert got.dtype == torch.int64 and int(got) == int(hit.sum())
    assert int(slab_mod.slab_count(*args)) == int(hit.sum())
