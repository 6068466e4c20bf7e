"""The far-origin edge crack on host-built and legacy scenes (ROADMAP queue 3
item 9): every scene the port builds or loads carries the exact-frame table
``a_lo``, and the walks test its leaves in the exact cluster frame.

A ray whose origin lies ~1e5 from a leaf rounds ``o - cc`` at ~0.004 of a
unit whoever built the scene, so with tv and w formed from the rounded
origin the two triangles of a shared edge see the ray apart and a seam
opens. The case: ``create_n_cubes(500)`` (cubes ~1e5 apart) and rays from
[-60, 60]^3 aimed at its centroids, every fourth turned away
(``chip_smoke.py::far_aimed_rays``): seed 17 with 8,192 rays and seed 1
with 32,768.

* Every host build (the group and the entry/exit walk of the native build,
  the numpy build, a packed build, a chain of parts of 2,000 triangles)
  and the legacy ``ClusterScene`` walk: the hit mask equals a float64
  oracle's (``test_torch_dynamic._oracle64``, chunked) on every ray, t
  within 2e-5 of the oracle's where both hit (the key truncation, up to
  W-1 ulps, is below that), and ids that differ from the oracle's are of
  the edge class (``assert_edge_class``).
* Rays 374, 2843 and 4003 of seed 17 hit triangles 1365, 2960 and 468 on
  both tight walks, the reference's host build's ids (its trace in
  interpret mode, exact reciprocal), at the oracle's t within 2e-4; the
  reference hits the oracle's 6,144 rays.
* The rounded forms are measured, never used as a path: the tight walks
  without ``a_lo`` (``._replace(a_lo=None)``) flip rays 374 and 2843 of
  seed 17 and nine of seed 1; the legacy walk's float32 form of before,
  tv = ((o' - a') + lo) - a_lo, flips two and seven.
* ``a_lo`` of the native, numpy and packed builds and of a chain's parts
  equals the float64 remainder (``test_torch_scene.exact_a_lo``), 0 on
  this scene, where every a' is exact; a save and load keeps it and the
  traces; the reference's file, which holds none, loads with zeros and
  traces with 0 flips too (o - cc is still formed exactly).
* ``render_hits_fast`` keeps the walk's hit where its float32 recompute in
  world coordinates (o - a rounded at ~1e5) puts the ray a rounding
  outside the walk's triangle: on rays of both seeds where that recompute
  rejects the winner, the rendered mask still equals the oracle's, t
  within 2e-5 of it, and the depth's gradients are finite.
"""

import numpy as np
import pytest
import torch

import bvh_tpu
import bvh_tpu.io as io_j
from bvh_tpu.ops.cluster import build_tight_scene as build_j
from bvh_tpu.ops.trace import trace_closest_hit_tight as closest_tight_j
import bvh_tpu_torch.io as io_t
from bvh_tpu_torch import Ray, ray_intersects_triangle
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.diff import render_depth_fast, render_hits_fast
from bvh_tpu_torch.ops import (build_chained_scene, build_cluster_scene,
                               build_tight_scene, trace_closest_hit,
                               trace_closest_hit_chained,
                               trace_closest_hit_tight)
from bvh_tpu_torch.ops import cluster_trace as ct_mod
from bvh_tpu_torch.ops import wide as wide_mod
from test_torch_dynamic import (PACKET, _aimed, _chunked, _oracle64,
                                assert_edge_class,
                                exact_recip)  # noqa: F401  (fixture)
from test_torch_scene import assert_a_lo
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
N_RAYS = {17: 8192, 1: 32768}  # rays of each seed
# the builds and walks: the native build's group and entry/exit walks, the
# numpy build's group walk, a packed build's entry/exit walk, a chain, and
# the legacy ClusterScene walk
CASES = ("group", "entry_exit", "numpy", "packed", "chained", "legacy")
# rays the rounded frame of the tight walks flips against the oracle
ROUNDED_FLIPS = {17: [374, 2843],
                 1: [2741, 5486, 8665, 19207, 21027, 21589, 24511, 24963,
                     31097]}
LEGACY_FLOAT32_FLIPS = {17: 2, 1: 7}  # the legacy walk's float32 form
NAMED = ((374, 1365), (2843, 2960), (4003, 468))  # seed 17: ray, triangle


@pytest.fixture(scope="module")
def cubes():
    return tb.create_n_cubes(500)


@pytest.fixture(scope="module")
def far(cubes):
    """far(seed) -> (o, d, (t64, s64)): the seed's rays and the float64
    oracle over them, each made once."""
    made = {}

    def get(seed):
        if seed not in made:
            o, d = _aimed(*cubes, N_RAYS[seed], seed=seed)
            d[::4] = -d[::4]
            made[seed] = (o, d, _chunked(_oracle64, o, d, cubes))
        return made[seed]
    return get


@pytest.fixture(scope="module")
def scenes(cubes):
    """scenes(case) -> the case's scene over create_n_cubes(500), each
    built once."""
    builds = {"group": lambda: build_tight_scene(*cubes),
              "numpy": lambda: build_tight_scene(*cubes, use_native=False),
              "packed": lambda: build_tight_scene(*cubes, packed=True),
              "chained": lambda: build_chained_scene(*cubes, max_part=2000),
              "legacy": lambda: build_cluster_scene(*cubes)}
    builds["entry_exit"] = builds["group"]
    made = {}

    def get(case):
        key = "group" if case == "entry_exit" else case
        if key not in made:
            made[key] = builds[key]()
        return made[key]
    return get


def _trace(case, scene, o, d):
    """``(t, shape_id)`` numpy of the case's walk over ``scene``."""
    rays = Ray.create(o, d, device=CPU)
    if case == "legacy":
        h = trace_closest_hit(scene, rays, device=CPU)
    elif case == "chained":
        h = trace_closest_hit_chained(scene, rays, packet=256, device=CPU)
    else:
        h = trace_closest_hit_tight(scene, rays, packet=256,
                                    wide=case in ("group", "numpy"),
                                    device=CPU)
    return h.t.numpy(), h.shape_id.numpy()


def _flips(t, t64):
    return np.nonzero(np.isfinite(t) != np.isfinite(t64))[0].tolist()


@pytest.mark.parametrize("seed", list(N_RAYS))
@pytest.mark.parametrize("case", CASES)
def test_far_origin_mask_equals_oracle(case, seed, cubes, far, scenes):
    o, d, (t64, s64) = far(seed)
    sc = scenes(case)
    parts = sc.parts if case == "chained" else (sc,)
    assert all(p.a_lo is not None for p in parts)
    if case == "chained":
        assert len(parts) == 3
    t, s = _trace(case, sc, o, d)
    assert _flips(t, t64) == []
    hit = np.isfinite(t)
    assert hit.sum() == N_RAYS[seed] * 3 // 4
    assert (np.abs(t[hit] - t64[hit]) <= 2e-5 * t64[hit]).all()
    off = np.nonzero(s != s64)[0]
    assert_edge_class(off, o, d, cubes, [(t, s), (t64, s64)])


@pytest.fixture(scope="module")
def reference_hits(cubes, far, exact_recip):
    """The reference's host build traced over seed 17's rays (interpret
    mode, exact reciprocal): ``(t, shape_id)``."""
    o, d, _ = far(17)
    hj = closest_tight_j(build_j(*cubes), bvh_tpu.Ray.create(o, d),
                         packet=PACKET, interpret=True)
    return np.asarray(hj.t), np.asarray(hj.shape_id)


@pytest.mark.parametrize("case", ["group", "entry_exit"])
def test_named_rays_hit_the_reference_ids(case, far, scenes, reference_hits):
    """Rays 374, 2843 and 4003, which the rounded frame misses or hits
    elsewhere, hit the reference's triangles at the oracle's t; the
    reference's mask is the oracle's."""
    o, d, (t64, s64) = far(17)
    t, s = _trace(case, scenes(case), o, d)
    t_r, s_r = reference_hits
    assert _flips(t_r, t64) == [] and np.isfinite(t_r).sum() == 6144
    for i, want in NAMED:
        assert s[i] == want == s_r[i], i
        assert abs(np.float64(t[i]) - t64[i]) <= 2e-4 * t64[i], i


def _float32_legacy_keys(rays, tiles, W, r, c, ccx, ccy, ccz, sent, row0,
                         frame):
    """The legacy walk's leaf test as it was before the exact frame took
    float64: tv = ((o' - a') + lo) - a_lo and w = tv x d in float32 (the
    ``narrow_keys`` call of ``ops/cluster_trace.py``, for measuring that
    form only)."""
    lo, alo = frame
    per_row = 128 // W
    lane = (c % per_row)[:, None] * W + torch.arange(W)[None, :]
    tri = tiles[(c // per_row)[:, None], lane]
    al = alo[(c // per_row)[:, None], lane]
    dv = tuple(rays[row0 + k, r][:, None] for k in range(3))
    op = tuple((rays[row0 + 3 + k, r] - cc)[:, None]
               for k, cc in enumerate((ccx, ccy, ccz)))
    tv = tuple(((op[k] - tri[..., k]) + lo[k][:, None]) - al[..., k]
               for k in range(3))
    return wide_mod.tri_keys(tri, tv, wide_mod._cross_rows(*tv, *dv), dv, W,
                             sent)


@pytest.mark.parametrize("seed", list(N_RAYS))
def test_rounded_forms_are_measured(seed, far, scenes, monkeypatch):
    """The forms the exact frame replaced, measured on the same rays: the
    tight walks without ``a_lo`` flip ``ROUNDED_FLIPS``, the legacy walk's
    float32 form ``LEGACY_FLOAT32_FLIPS`` rays (never a path)."""
    o, d, (t64, _) = far(seed)
    rounded = scenes("group")._replace(a_lo=None)
    for case in ("group", "entry_exit"):
        t, _ = _trace(case, rounded, o, d)
        assert _flips(t, t64) == ROUNDED_FLIPS[seed], case
    monkeypatch.setattr(ct_mod, "narrow_keys", _float32_legacy_keys)
    t, _ = _trace("legacy", scenes("legacy"), o, d)
    assert len(_flips(t, t64)) == LEGACY_FLOAT32_FLIPS[seed]


@pytest.mark.parametrize("case", ["group", "numpy", "packed", "chained"])
def test_host_a_lo_is_the_exact_remainder(case, cubes, scenes):
    """``a_lo`` of every lane is (a - cc) - a' in float64 rounded once, cc
    the frame origin the walks read (a packed scene's raw packed-row
    value); a chain's parts over their own vertices, padded with zeros to
    the chain's group rows. On these builds every a' is exact (0): their
    leaf boxes lie a few units around their triangles, so the crack came
    from the ray's rounded ``o - cc`` alone."""
    sc = scenes(case)
    a = cubes[0]
    parts = sc.parts if case == "chained" else (sc,)
    ids = sc.orig_ids if case == "chained" else (np.arange(len(a)),)
    for part, i in zip(parts, ids):
        assert_a_lo(part, a[i])
        assert not np.asarray(part.a_lo).any()


def test_round_trip_keeps_a_lo(tmp_path, far, scenes):
    """A host build saved and loaded keeps ``a_lo`` and traces seed 17's
    rays bit for bit as before."""
    o, d, _ = far(17)
    sc = scenes("group")
    path = str(tmp_path / "host.npz")
    io_t.save_tight_scene(path, sc)
    back = io_t.load_tight_scene(path)
    assert np.array_equal(back.a_lo, sc.a_lo)
    for case in ("group", "entry_exit"):
        t0, s0 = _trace(case, sc, o, d)
        t1, s1 = _trace(case, back, o, d)
        assert np.array_equal(t0.view(np.int32), t1.view(np.int32))
        assert np.array_equal(s0, s1)


def test_reference_file_loads_with_zeros(tmp_path, cubes, far):
    """The reference's host build written by ``bvh_tpu.io`` (no ``a_lo``
    key) loads with zeros, and both walks over it meet the oracle's mask
    on seed 17's rays."""
    o, d, (t64, _) = far(17)
    path = str(tmp_path / "reference.npz")
    io_j.save_tight_scene(path, build_j(*cubes))
    back = io_t.load_tight_scene(path)
    assert_a_lo(back)
    for case in ("group", "entry_exit"):
        t, _ = _trace(case, back, o, d)
        assert _flips(t, t64) == [], case


@pytest.mark.parametrize("seed", list(N_RAYS))
def test_render_keeps_the_walks_far_hits(seed, cubes, far, scenes):
    """The far rays on which the float32 recompute rejects the walk's
    triangle (a rounding outside its edge) are hits of ``render_hits_fast``
    at the oracle's t; every ray's hit equals the oracle's, and the depth's
    gradients are finite."""
    o, d, (t64, _) = far(seed)
    sc = scenes("group")
    rays = Ray.create(o, d, device=CPU)
    tris = tuple(torch.from_numpy(x) for x in cubes)
    hard = trace_closest_hit_tight(sc, rays, packet=256, device=CPU)
    sid = hard.shape_id.to(torch.int64)
    check = ray_intersects_triangle(
        rays, *(x[sid.clamp_min(0)] for x in tris)).distance
    rejected = ((sid >= 0) & ~torch.isfinite(check)).numpy()
    assert rejected.sum() > 0
    h = render_hits_fast(sc, rays, *tris, packet=256, device=CPU)
    t = h.t.numpy()
    assert _flips(t, t64) == []
    assert np.array_equal(h.shape_id.numpy(), hard.shape_id.numpy())
    hit = np.isfinite(t)
    assert (np.abs(t[hit] - t64[hit]) <= 2e-5 * t64[hit]).all()
    av, bv, cv = (x.clone().requires_grad_() for x in tris)
    depth, mask = render_depth_fast(sc, rays, av, bv, cv, packet=256,
                                    device=CPU)
    assert np.array_equal(mask.numpy(), hit)
    depth[torch.from_numpy(rejected)].sum().backward()
    for g in (av.grad, bv.grad, cv.grad):
        assert torch.isfinite(g).all()
    assert float(av.grad.abs().sum()) > 0
