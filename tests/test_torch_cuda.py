"""The port's CUDA kernels on the card, against their plain PyTorch versions
on the same tensors (bit for bit), their counting builds against the timed
builds and the plain walks' counts, the whole traces (closest hit on both
walks, any hit, the legacy cluster trace, chained scenes, k-closest) and
the nearest queries on the card against the CPU, and the device builds,
refits and updates on the card against the CPU. Every test here needs
an NVIDIA GPU and skips elsewhere; the file imports no JAX, so it runs
where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from bvh_tpu_torch import Ray, ray_intersects_aabb
from bvh_tpu_torch import obs
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.diff import render_depth_fast
from bvh_tpu_torch.ops import (build_chained_scene,
                               build_chained_scene_device,
                               build_cluster_scene, build_tight_scene,
                               build_tight_scene_device, count_visits_nearest,
                               count_visits_tight, count_visits_wide,
                               make_chained_updater, make_key_planner,
                               make_refitter, make_updater,
                               make_planner, make_seeder, make_tracer,
                               nearest_chained, nearest_tight, sort_rays,
                               sort_rays_device,
                               trace_any_hit_chained, trace_any_hit_tight,
                               trace_closest_hit, trace_closest_hit_chained,
                               trace_closest_hit_seeded,
                               trace_closest_hit_tight, trace_k_closest,
                               trace_k_closest_chained)
from bvh_tpu_torch.ops import cluster_trace as ct_mod
from bvh_tpu_torch.ops import nearest as near_mod
from bvh_tpu_torch.ops import sweep as sweep_mod
from bvh_tpu_torch.ops import tight as tight_mod
from bvh_tpu_torch.ops import trace as trace_mod
from bvh_tpu_torch.ops import wide as wide_mod
from bvh_tpu_torch.ops.cluster import wide_group_meta
from bvh_tpu_torch.ops.trace import _dev, _ray_rows

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _rays(a, n=8192, seed=0):
    o1, d1 = tb.create_rays(n // 2, seed=tb.seed_state_after(seed))
    o2, d2 = tb.aimed_rays(a, n // 2, seed=seed)
    return np.concatenate([o1, o2]), np.concatenate([d1, d2])


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def _rec(scene, dev):
    """The scene's wide table in the group-walk kernel's layout on dev."""
    return _dev(scene.gnodes, dev, wide_mod.group_records)


def _nrec(table, dev):
    """An entry/exit table in the sweep and entry/exit kernels' layout on
    dev."""
    return _dev(table, dev, sweep_mod.node_records)


def _to(rays, dev):
    """The same ray tensors on ``dev`` (each device would normalize the
    directions itself, the card's square root 1 ulp off on some)."""
    return Ray(*(x.to(dev) for x in rays))


def _equal(got, ref):
    """A query's result on the card equals the CPU's on the same inputs bit
    for bit: every field of a record or tuple, or the one tensor."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for x, y in zip(got, ref):
        assert torch.equal(_bits(x.cpu()), _bits(y))


@pytest.fixture(scope="module", params=["cubes_w16", "cubes_w64", "mesh_w128"])
def case(request, cuda):
    if request.param == "mesh_w128":
        a, b, c = tb.create_dense_mesh(120)
        scene = build_tight_scene(a, b, c, leaf_size=128)
        rng = np.random.default_rng(3)
        o = rng.uniform(-100, 100, (8192, 3)).astype(np.float32)
        o[:, 1] = 40.0
        d = rng.normal(size=(8192, 3)).astype(np.float32)
        d[:, 1] = -np.abs(d[:, 1])
    else:
        a, b, c = tb.create_n_cubes(500)
        scene = build_tight_scene(
            a, b, c, leaf_size=16 if request.param == "cubes_w16" else 64)
        o, d = _rays(a)
    rays = Ray.create(o, d, device=cuda)
    tm = torch.rand(len(o), generator=torch.Generator().manual_seed(2)) * 80
    return scene, (a, b, c), o, d, rays, tm.to(cuda)


def _points(case, n=8192):
    """Points near the triangles (half of them with a radius) and, on the
    cube scenes, points in the reference's random range."""
    scene, (a, b, c), *_ = case
    rng = np.random.default_rng(6)
    cen = (a + b + c) / 3.0
    if scene.width == 128:  # the dense mesh
        pts = cen[rng.integers(0, len(cen), n)] + rng.normal(size=(n, 3))
        d_max = np.where(np.arange(n) % 2 == 0, 2.0, np.inf)
    else:
        pts = np.concatenate([
            cen[rng.integers(0, len(cen), n // 2)]
            + rng.normal(scale=20.0, size=(n // 2, 3)),
            rng.uniform(-1.2e5, 1.2e5, (n // 2, 3))])
        d_max = np.where(np.arange(n) % 2 == 0, 30.0, np.inf)
    return pts.astype(np.float32), d_max.astype(np.float32)


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("walk", ["wide", "entry_exit"])
def test_nearest_kernel_matches_plain(case, cuda, walk, refine):
    scene = case[0]
    pts, d_max = _points(case)
    rows = near_mod.point_rows(torch.from_numpy(pts).to(cuda),
                               torch.from_numpy(d_max).to(cuda))
    grp = _dev(scene.groups, cuda)
    if walk == "wide":
        gn = _dev(scene.gnodes, cuda)
        before = obs.counted("launch.nearest_wide")
        dk, ik = near_mod.nearest_wide(gn, grp, rows, scene.width,
                                       scene.gdepth, refine=refine)
        assert obs.counted("launch.nearest_wide") == before + 1
        dp, ip = near_mod.nearest_wide_plain(gn, grp, rows, scene.width,
                                             refine=refine)
    else:
        sn = _dev(scene.smem_nodes, cuda)
        before = obs.counted("launch.nearest_entry_exit")
        dk, ik = near_mod.nearest_entry_exit(sn, grp, rows, scene.width,
                                             refine=refine)
        assert obs.counted("launch.nearest_entry_exit") == before + 1
        dp, ip = near_mod.nearest_entry_exit_plain(sn, grp, rows, scene.width,
                                                   refine=refine)
    torch.cuda.synchronize()
    assert torch.equal(_bits(dk), _bits(dp))
    assert torch.equal(ik, ip)
    assert (ik >= 0).any() and (ik < 0).any()


def test_nearest_on_card_matches_cpu(case, cuda):
    scene = case[0]
    pts, d_max = _points(case)
    for wide in (None, False):
        sid, dist = nearest_tight(scene, pts, d_max=d_max, wide=wide,
                                  device=cuda)
        sid_c, dist_c = nearest_tight(scene, pts, d_max=d_max, wide=wide,
                                      device="cpu")
        assert torch.equal(sid.cpu(), sid_c)
        assert torch.equal(_bits(dist.cpu()), _bits(dist_c))


@pytest.mark.parametrize("mode", ["closest", "bounded", "gated"])
def test_wide_kernel_matches_plain(case, cuda, mode):
    scene, _, _, _, rays, tm = case
    inf = torch.full_like(tm, float("inf"))
    rows = _ray_rows(rays, tm if mode == "bounded" else inf)
    gn, grp = _dev(scene.gnodes, cuda), _dev(scene.groups, cuda)
    gate = None
    if mode == "gated":
        gate = sweep_mod.sweep_gate(_nrec(scene.smem_nodes, cuda), rows, 256)
    kw = dict(gate=gate, packet=256, bounded=mode == "bounded")
    before = obs.counted("launch.wide_trace")
    tk, ik = wide_mod.wide_trace(_rec(scene, rows.device), grp, rows,
                                 scene.width, scene.gdepth, **kw)
    assert obs.counted("launch.wide_trace") == before + 1
    tp, ip = wide_mod.wide_trace_plain(gn, grp, rows, scene.width, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(tk), _bits(tp))
    assert torch.equal(ik, ip)
    assert (ik >= 0).any()


@pytest.mark.parametrize("packet", [128, 1024])
def test_sweep_kernel_matches_plain(case, cuda, packet):
    scene, _, _, _, rays, tm = case
    sn = _dev(scene.smem_nodes, cuda)
    for t_max in (torch.full_like(tm, float("inf")), tm):
        rows = _ray_rows(rays, t_max)
        before = obs.counted("launch.sweep")
        gk = sweep_mod.sweep_gate(_nrec(scene.smem_nodes, cuda), rows, packet)
        assert obs.counted("launch.sweep") == before + 1
        gp = sweep_mod.sweep_gate_plain(sn, rows, packet)
        torch.cuda.synchronize()
        assert torch.equal(gk, gp)


def test_tracer_on_card_matches_cpu(case, cuda):
    scene, tris, o, d, _, _ = case
    got = make_tracer(scene, packet=512, sort="morton", tris=tris,
                      device=cuda)(o, d)
    ref = make_tracer(scene, packet=512, sort="morton", tris=tris,
                      device="cpu")(o, d)
    # the two devices may normalize a direction 1 ulp apart; the kernels
    # themselves agree bit for bit (above)
    hit = torch.isfinite(ref.t)
    assert torch.equal(torch.isfinite(got.t).cpu(), hit)
    same = got.shape_id.cpu() == ref.shape_id
    assert same.float().mean() > 0.999
    torch.testing.assert_close(got.t.cpu()[hit & same], ref.t[hit & same],
                               rtol=1e-6, atol=0)


def test_wrapper_refuses_mixed_devices(case, cuda):
    scene, _, _, _, rays, tm = case
    rows = _ray_rows(rays, tm)
    with pytest.raises(ValueError, match="records"):
        wide_mod.wide_trace(_rec(scene, "cpu"), _dev(scene.groups, cuda),
                            rows, scene.width, scene.gdepth)
    with pytest.raises(ValueError, match="gate"):
        wide_mod.wide_trace(_rec(scene, cuda), _dev(scene.groups, cuda),
                            rows, scene.width, scene.gdepth,
                            gate=torch.ones(64, dtype=torch.int32), packet=128)


def _hints(ids, p, k=4, seed=0):
    """Random valid hints [p, k] drawn from ``ids``; the first packet's are
    off (-1 in its first slot)."""
    rng = np.random.default_rng(seed)
    h = rng.choice(np.asarray(ids), size=(p, k)).astype(np.int32)
    h[0, 0] = -1
    return h


@pytest.mark.parametrize("mode", ["closest", "bounded", "any", "any_bounded",
                                  "gated", "hinted", "packed", "packed_any"])
def test_tight_kernel_matches_plain(case, cuda, mode):
    scene, tris, _, _, rays, tm = case
    inf = torch.full_like(tm, float("inf"))
    bounded = mode in ("bounded", "any_bounded", "packed_any")
    rows = _ray_rows(rays, tm if bounded else inf)
    packed = mode.startswith("packed")
    if packed:
        scene = build_tight_scene(*tris, leaf_size=scene.width, packed=True)
    host = scene.packed_nodes if packed else scene.smem_nodes
    table, rec = _dev(host, cuda), _nrec(host, cuda)
    grp = _dev(scene.groups, cuda)
    packet = 256
    p = -(-rows.shape[1] // packet)
    kw = dict(packed=packed, packet=packet, bounded=bounded,
              mode="any" if "any" in mode else "closest")
    if mode == "gated":
        kw["gate"] = sweep_mod.sweep_gate(rec, rows, packet)
    if mode == "hinted":
        leaves = np.nonzero(scene.smem_nodes[6] < 0)[0]
        kw["hints"] = torch.from_numpy(_hints(leaves, p)).to(cuda)
    before = obs.counted("launch.tight_trace")
    tk, ik = tight_mod.tight_trace(rec, grp, rows, scene.width, **kw)
    assert obs.counted("launch.tight_trace") == before + 1
    tp, ip = tight_mod.tight_trace_plain(table, grp, rows, scene.width, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(tk), _bits(tp))
    assert torch.equal(ik, ip)
    assert (ik >= 0).any()


@pytest.mark.parametrize("mode", ["any", "any_bounded", "hinted"])
def test_wide_kernel_any_and_hints_match_plain(case, cuda, mode):
    scene, _, _, _, rays, tm = case
    bounded = mode == "any_bounded"
    rows = _ray_rows(rays, tm if bounded else torch.full_like(tm, np.inf))
    gn, grp = _dev(scene.gnodes, cuda), _dev(scene.groups, cuda)
    packet = 256
    kw = dict(packet=packet, bounded=bounded,
              mode="closest" if mode == "hinted" else "any")
    if mode == "hinted":
        p = -(-rows.shape[1] // packet)
        kw["hints"] = torch.from_numpy(_hints(scene.gslot, p)).to(cuda)
    before = obs.counted("launch.wide_trace")
    tk, ik = wide_mod.wide_trace(_rec(scene, rows.device), grp, rows,
                                 scene.width, scene.gdepth, **kw)
    assert obs.counted("launch.wide_trace") == before + 1
    tp, ip = wide_mod.wide_trace_plain(gn, grp, rows, scene.width, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(tk), _bits(tp))
    assert torch.equal(ik, ip)
    assert (ik >= 0).any()


@pytest.mark.parametrize("packed", [False, True])
def test_sweep_packed_and_pre_gate_match_plain(case, cuda, packed):
    scene, tris, _, _, rays, tm = case
    if packed:
        scene = build_tight_scene(*tris, leaf_size=scene.width, packed=True)
    host = scene.packed_nodes if packed else scene.smem_nodes
    table = _dev(host, cuda)
    rows = _ray_rows(rays, tm)
    packet = 128
    p = -(-rows.shape[1] // packet)
    pre = torch.from_numpy(np.resize(np.array([1, 0, 1], np.int32), p)).to(cuda)
    for pre_gate in (None, pre):
        gk = sweep_mod.sweep_gate(_nrec(host, cuda), rows, packet,
                                  packed=packed, pre_gate=pre_gate)
        gp = sweep_mod.sweep_gate_plain(table, rows, packet, packed=packed,
                                        pre_gate=pre_gate)
        torch.cuda.synchronize()
        assert torch.equal(gk, gp)
        if pre_gate is not None:
            assert not bool((gk & (1 - pre)).any())


@pytest.mark.parametrize("wide", [None, False])
def test_any_hit_on_card_matches_cpu(case, cuda, wide):
    scene, _, o, d, _, tm = case
    for t_max in (None, tm.cpu().numpy()):
        got = trace_any_hit_tight(scene, Ray.create(o, d, device=cuda),
                                  t_max=t_max, packet=512, wide=wide,
                                  sweep=True, device=cuda)
        ref = trace_any_hit_tight(scene, Ray.create(o, d, device="cpu"),
                                  t_max=t_max, packet=512, wide=wide,
                                  sweep=True, device="cpu")
        # the two devices may normalize a direction 1 ulp apart
        assert (got.cpu() != ref).float().mean() < 1e-3
        assert ref.any() and not ref.all()


@pytest.mark.parametrize("kwargs", [{"wide": False}, {"packed": True}])
def test_entry_exit_tracer_on_card_matches_cpu(case, cuda, kwargs):
    _, tris, o, d, _, _ = case
    scene = build_tight_scene(*tris, leaf_size=case[0].width, **kwargs)
    got = make_tracer(scene, packet=512, sort="morton", tris=tris,
                      device=cuda)(o, d)
    ref = make_tracer(scene, packet=512, sort="morton", tris=tris,
                      device="cpu")(o, d)
    hit = torch.isfinite(ref.t)
    assert torch.equal(torch.isfinite(got.t).cpu(), hit)
    same = got.shape_id.cpu() == ref.shape_id
    assert same.float().mean() > 0.999
    torch.testing.assert_close(got.t.cpu()[hit & same], ref.t[hit & same],
                               rtol=1e-6, atol=0)


# ---- the legacy cluster trace ----------------------------------------------

@pytest.fixture(scope="module")
def legacy(cuda):
    a, b, c = tb.create_n_cubes(500)
    o, d = _rays(a)
    perm, _ = sort_rays(o, d)
    return (a, b, c), o[perm], d[perm]


@pytest.mark.parametrize("mode", ["relative", "global", "skip_narrow"])
def test_cluster_kernel_matches_plain(legacy, cuda, mode):
    tris, o, d = legacy
    scene = build_cluster_scene(*tris, relative=mode != "global")
    rows = ct_mod.ray_rows(Ray.create(o, d, device=cuda))
    tables = (_dev(scene.smem_nodes, cuda), _dev(scene.smem_cc, cuda),
              _dev(scene.tris_rel, cuda), _dev(scene.a_lo, cuda))
    kw = dict(relative=scene.relative, skip_narrow=mode == "skip_narrow")
    before = obs.counted("launch.cluster_trace")
    tk, ik = ct_mod.cluster_trace(*tables, rows, **kw)
    assert obs.counted("launch.cluster_trace") == before + 1
    tp, ip = ct_mod.cluster_trace_plain(*tables, rows, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(tk), _bits(tp))
    assert torch.equal(ik, ip)
    assert (ik >= 0).any() != (mode == "skip_narrow")


@pytest.mark.parametrize("relative", [True, False])
def test_legacy_trace_on_card_matches_cpu(legacy, cuda, relative):
    tris, o, d = legacy
    scene = build_cluster_scene(*tris, relative=relative)
    rays = Ray.create(o, d, device="cpu")
    for kw in ({}, {"tris": tris}):
        got = trace_closest_hit(scene, _to(rays, cuda), device=cuda, **kw)
        ref = trace_closest_hit(scene, rays, device="cpu", **kw)
        assert torch.isfinite(ref.t).any()
        _equal(got, ref)


# ---- chained scenes and k-closest ------------------------------------------

@pytest.fixture(scope="module")
def chained(cuda):
    a, b, c = tb.create_n_cubes(400)
    o, d = _rays(a, n=4096)
    return (a, b, c), build_chained_scene(a, b, c, max_part=1500), o, d


@pytest.mark.parametrize("case", ["closest", "t_max_perm_tris", "packed"])
def test_closest_chained_on_card_matches_cpu(chained, cuda, case):
    tris, ch, o, d = chained
    if case == "packed":
        ch = build_chained_scene(*tris, max_part=1500, packed=True)
    kw = {}
    if case == "t_max_perm_tris":
        t_max = np.random.default_rng(4).uniform(20, 80, len(o))
        perm = np.argsort(o[:, 0], kind="stable")
        kw = dict(t_max=t_max.astype(np.float32), perm=perm, tris=tris)
    rays = Ray.create(o, d, device="cpu")
    walks = ("launch.wide_trace", "launch.tight_trace")
    before = [obs.counted(k) for k in walks]
    got = trace_closest_hit_chained(ch, _to(rays, cuda), packet=512,
                                    device=cuda, **kw)
    assert [obs.counted(k) for k in walks] != before
    ref = trace_closest_hit_chained(ch, rays, packet=512, device="cpu", **kw)
    assert torch.isfinite(ref.t).any()
    _equal(got, ref)


def test_any_chained_on_card_matches_cpu(chained, cuda):
    _, ch, o, d = chained
    rays = Ray.create(o, d, device="cpu")
    # the aimed rays hit at about 49.5, the random ones rarely within 60
    for t_max in (None, np.full(len(o), 60.0, np.float32)):
        got = trace_any_hit_chained(ch, _to(rays, cuda), t_max=t_max,
                                    packet=512, device=cuda)
        ref = trace_any_hit_chained(ch, rays, t_max=t_max, packet=512,
                                    device="cpu")
        assert ref.any() and not ref.all()
        _equal(got, ref)


def test_nearest_chained_on_card_matches_cpu(chained, cuda):
    tris, ch, _, _ = chained
    rng = np.random.default_rng(6)
    cen = (tris[0] + tris[1] + tris[2]) / 3.0
    pts = (cen[rng.integers(0, len(cen), 4096)]
           + rng.normal(scale=20.0, size=(4096, 3))).astype(np.float32)
    before = obs.counted("launch.nearest_wide")
    sid, dist = nearest_chained(ch, pts, device=cuda)
    assert obs.counted("launch.nearest_wide") == before + len(ch.parts)
    sid_c, dist_c = nearest_chained(ch, pts, device="cpu")
    assert torch.equal(sid.cpu(), sid_c)
    assert torch.equal(_bits(dist.cpu()), _bits(dist_c))


def test_k_closest_on_card_matches_cpu(chained, cuda):
    tris, ch, o, d = chained
    scene = build_tight_scene(*tris)
    rays = Ray.create(o, d, device="cpu")
    for fn, sc in ((trace_k_closest, scene), (trace_k_closest_chained, ch)):
        got = fn(sc, _to(rays, cuda), k=3, packet=512, tris=tris, device=cuda)
        ref = fn(sc, rays, k=3, packet=512, tris=tris, device="cpu")
        assert (ref[2] > 0).any()
        _equal(got, ref)


def test_k_closest_stacked_on_card_matches_cpu(cuda):
    """Rays along a stack of cubes cross several front faces, so every slot
    of the peel is exercised (the aimed rays above find one hit each)."""
    rng = np.random.default_rng(71)
    a, b, c = (x.copy() for x in tb.create_n_cubes(60))
    for i in range(60):
        sl = slice(12 * i, 12 * (i + 1))
        ctr = (a[sl] + b[sl] + c[sl]).mean(axis=0) / 3.0
        new = np.array([rng.uniform(-1.5, 1.5), rng.uniform(-1.5, 1.5),
                        8.0 * i], np.float32)
        for arr in (a, b, c):
            arr[sl] += new - ctr
    n = 2048
    o = np.concatenate([rng.uniform(-1, 1, (n, 2)), np.full((n, 1), -30.0)],
                       axis=1).astype(np.float32)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    d[:, :2] = rng.normal(scale=0.01, size=(n, 2))
    tris = (a, b, c)
    rays = Ray.create(o, d, device="cpu")
    for fn, sc in ((trace_k_closest, build_tight_scene(*tris)),
                   (trace_k_closest_chained,
                    build_chained_scene(*tris, max_part=300))):
        got = fn(sc, _to(rays, cuda), k=5, packet=256, tris=tris, device=cuda)
        ref = fn(sc, rays, k=5, packet=256, tris=tris, device="cpu")
        assert (ref[2] > 2).float().mean() > 0.2
        _equal(got, ref)


# ---- the warp schedules of the cluster walk and the nearest group walk ----
#
# Both kernels run a warp of 32 rays or points together (a shared cursor or
# group order, leaf tests shared by the lanes that fire them); these inputs
# stress that: unsorted rows (the most divergence), counts that leave a
# warp ragged, and warps in which one lane fires.

def _shuffled(n, *arrays, seed=0):
    perm = np.random.default_rng(seed).permutation(n)
    return tuple(x[perm] for x in arrays)


@pytest.mark.parametrize("mode", ["relative", "global", "skip_narrow"])
@pytest.mark.parametrize("n", [1, 31, 33, 65537])
def test_cluster_kernel_warp_schedule(cuda, n, mode):
    a, b, c = tb.create_n_cubes(500)
    o, d = _rays(a, n=65538)
    o, d = _shuffled(65538, o, d, seed=n)
    o, d = o[:n], d[:n]
    scene = build_cluster_scene(a, b, c, relative=mode != "global")
    rows = ct_mod.ray_rows(Ray.create(o, d, device=cuda))
    tables = (_dev(scene.smem_nodes, cuda), _dev(scene.smem_cc, cuda),
              _dev(scene.tris_rel, cuda), _dev(scene.a_lo, cuda))
    kw = dict(relative=scene.relative, skip_narrow=mode == "skip_narrow")
    tk, ik = ct_mod.cluster_trace(*tables, rows, **kw)
    tp, ip = ct_mod.cluster_trace_plain(*tables, rows, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(tk), _bits(tp))
    assert torch.equal(ik, ip)
    if mode == "skip_narrow":
        assert not (ik >= 0).any()
    elif n > 33:
        assert (ik >= 0).any() and (ik < 0).any()


def _one_lane_rows(a, n_warps, lanes):
    """Rays of which only lane ``lanes[w]`` of each warp w is aimed at a
    cube; the others start beyond the scene and point away from it."""
    n = 32 * n_warps
    ao, ad = tb.aimed_rays(a, n, seed=7)
    o = np.full((n, 3), 3e5, np.float32)
    d = np.tile(np.array([[1.0, 0.5, 0.25]], np.float32), (n, 1))
    idx = 32 * np.arange(n_warps) + np.asarray(lanes)
    o[idx], d[idx] = ao[idx], ad[idx]
    return o, d, idx


@pytest.mark.parametrize("relative", [True, False])
def test_cluster_kernel_one_lane_fires(cuda, relative):
    a, b, c = tb.create_n_cubes(500)
    o, d, idx = _one_lane_rows(a, 4, [0, 5, 17, 31])
    scene = build_cluster_scene(a, b, c, relative=relative)
    rows = ct_mod.ray_rows(Ray.create(o, d, device=cuda))
    tables = (_dev(scene.smem_nodes, cuda), _dev(scene.smem_cc, cuda),
              _dev(scene.tris_rel, cuda), _dev(scene.a_lo, cuda))
    tk, ik = ct_mod.cluster_trace(*tables, rows, relative=relative)
    tp, ip = ct_mod.cluster_trace_plain(*tables, rows, relative=relative)
    torch.cuda.synchronize()
    assert torch.equal(_bits(tk), _bits(tp))
    assert torch.equal(ik, ip)
    hit = (ik >= 0).cpu().numpy()
    assert hit[idx].all() and hit.sum() == len(idx)


@pytest.fixture(scope="module")
def wide_scenes(cuda):
    """One scene per cluster width: the cube scene at W = 16, 32 and 64,
    the dense mesh at W = 128, with their triangles."""
    out = {}
    cubes = tb.create_n_cubes(500)
    for w in (16, 32, 64):
        out[w] = (build_tight_scene(*cubes, leaf_size=w), cubes)
    mesh = tb.create_dense_mesh(120)
    out[128] = (build_tight_scene(*mesh, leaf_size=128), mesh)
    for w, (sc, _) in out.items():
        assert sc.width == w and sc.gnodes is not None
    return out


def _near_rows(pts, d_max, dev):
    return near_mod.point_rows(torch.from_numpy(pts).to(dev),
                               torch.from_numpy(d_max).to(dev))


def _near_pair(scene, rows, dev, refine):
    gn, grp = _dev(scene.gnodes, dev), _dev(scene.groups, dev)
    before = obs.counted("launch.nearest_wide")
    dk, ik = near_mod.nearest_wide(gn, grp, rows, scene.width, scene.gdepth,
                                   refine=refine)
    assert obs.counted("launch.nearest_wide") == before + 1
    dp, ip = near_mod.nearest_wide_plain(gn, grp, rows, scene.width,
                                         refine=refine)
    torch.cuda.synchronize()
    assert torch.equal(_bits(dk), _bits(dp))
    assert torch.equal(ik, ip)
    return ik


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("n", [1, 31, 33, 65537])
@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_nearest_wide_warp_schedule(wide_scenes, cuda, width, n, refine):
    scene, (a, b, c) = wide_scenes[width]
    rng = np.random.default_rng(n + width)
    cen = (a + b + c) / 3.0
    m = 65538
    near = cen[rng.integers(0, len(cen), m // 2)] + rng.normal(
        scale=3.0, size=(m // 2, 3))
    lo, hi = a.min(axis=0) - 50.0, a.max(axis=0) + 50.0
    far = rng.uniform(lo, hi, (m // 2, 3))
    pts = np.concatenate([near, far]).astype(np.float32)
    # every third point has a radius of 5
    d_max = np.where(np.arange(m) % 3 == 0, 5.0, np.inf).astype(np.float32)
    pts, d_max = _shuffled(m, pts, d_max, seed=n)
    ik = _near_pair(scene, _near_rows(pts[:n], d_max[:n], cuda), cuda, refine)
    if n > 33:
        assert (ik >= 0).any() and (ik < 0).any()


@pytest.mark.parametrize("n", [1, 31, 33, 65537])
@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_nearest_seed_kernel_matches_plain(wide_scenes, cuda, width, n):
    """The bound seed on the card, timed and with counts, against its plain
    version on the same rows (points near the triangles and far off,
    unsorted, every third with a radius of 5) bit for bit; the seeded rows
    then give the unseeded walk's d2 bit for bit."""
    scene, (a, b, c) = wide_scenes[width]
    rng = np.random.default_rng(n + 3 * width)
    cen = (a + b + c) / 3.0
    m = 65537
    pts = np.concatenate([
        cen[rng.integers(0, len(cen), m // 2)]
        + rng.normal(scale=3.0, size=(m // 2, 3)),
        rng.uniform(a.min(axis=0) - 50, a.max(axis=0) + 50,
                    (m - m // 2, 3))]).astype(np.float32)
    d_max = np.where(np.arange(m) % 3 == 0, 5.0, np.inf).astype(np.float32)
    pts, d_max = _shuffled(m, pts, d_max, seed=n)
    rows = _near_rows(pts[:n], d_max[:n], cuda)
    gn = _dev(scene.gnodes, cuda)
    got, got_c, want = rows.clone(), rows.clone(), rows.clone()
    before = [obs.counted(k) for k in ("launch.nearest_seed",
                                       "launch.nearest_seed_count")]
    assert near_mod.nearest_seed(gn, got) is None
    tests = near_mod.nearest_seed(gn, got_c, counts=True)
    assert [obs.counted(k) for k in ("launch.nearest_seed",
                                     "launch.nearest_seed_count")] == [
        before[0] + 1, before[1] + 1]
    tests_p = near_mod.nearest_seed_plain(gn, want, counts=True)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got_c), _bits(want))
    assert torch.equal(tests, tests_p)
    assert bool((got[3] <= rows[3]).all())
    grp = _dev(scene.groups, cuda)
    d0, _ = near_mod.nearest_wide(gn, grp, rows, width, scene.gdepth)
    d1, _ = near_mod.nearest_wide(gn, grp, got, width, scene.gdepth)
    assert torch.equal(_bits(d0), _bits(d1))


@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_nearest_wide_one_lane_fires(wide_scenes, cuda, width):
    """Points whose radius is 0 fire no box; one lane of each warp has none
    and so walks and narrowphases alone."""
    scene, (a, b, c) = wide_scenes[width]
    n_warps = 4
    cen = (a + b + c) / 3.0
    pts = cen[np.random.default_rng(8).integers(0, len(cen), 32 * n_warps)]
    d_max = np.zeros(32 * n_warps, np.float32)
    idx = 32 * np.arange(n_warps) + np.array([0, 9, 16, 31])
    d_max[idx] = np.inf
    ik = _near_pair(scene, _near_rows(pts.astype(np.float32), d_max, cuda),
                    cuda, True)
    hit = (ik >= 0).cpu().numpy()
    assert hit[idx].all() and hit.sum() == len(idx)


# ---- the warp forms of the entry/exit nearest walk and the group walk ------
# The entry/exit nearest walk runs a warp of 32 points over the union of its
# points' nodes; the group walk keeps one ray a lane in lock step but tests
# the leaves its lanes fire with the whole warp (and reads a group-major
# copy of the table). The same stresses as above, plus a table 14 groups
# deep (testbase.chain_tables), the deepest the wrappers take.

def _near_ee_pair(scene, rows, dev, refine):
    sn, grp = _dev(scene.smem_nodes, dev), _dev(scene.groups, dev)
    before = obs.counted("launch.nearest_entry_exit")
    dk, ik = near_mod.nearest_entry_exit(sn, grp, rows, scene.width,
                                         refine=refine)
    assert obs.counted("launch.nearest_entry_exit") == before + 1
    dp, ip = near_mod.nearest_entry_exit_plain(sn, grp, rows, scene.width,
                                               refine=refine)
    torch.cuda.synchronize()
    assert torch.equal(_bits(dk), _bits(dp))
    assert torch.equal(ik, ip)
    return ik


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("n", [1, 31, 33, 65537])
@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_nearest_entry_exit_warp_schedule(wide_scenes, cuda, width, n, refine):
    scene, (a, b, c) = wide_scenes[width]
    rng = np.random.default_rng(n + 3 * width)
    cen = (a + b + c) / 3.0
    m = 65538
    near = cen[rng.integers(0, len(cen), m // 2)] + rng.normal(
        scale=3.0, size=(m // 2, 3))
    lo, hi = a.min(axis=0) - 50.0, a.max(axis=0) + 50.0
    far = rng.uniform(lo, hi, (m // 2, 3))
    pts = np.concatenate([near, far]).astype(np.float32)
    d_max = np.where(np.arange(m) % 3 == 0, 5.0, np.inf).astype(np.float32)
    pts, d_max = _shuffled(m, pts, d_max, seed=n + 1)
    ik = _near_ee_pair(scene, _near_rows(pts[:n], d_max[:n], cuda), cuda,
                       refine)
    if n > 33:
        assert (ik >= 0).any() and (ik < 0).any()


@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_nearest_entry_exit_one_lane_fires(wide_scenes, cuda, width):
    """Points whose radius is 0 fire no box; one lane of each warp has none
    and so walks and narrowphases alone."""
    scene, (a, b, c) = wide_scenes[width]
    n_warps = 4
    cen = (a + b + c) / 3.0
    pts = cen[np.random.default_rng(9).integers(0, len(cen), 32 * n_warps)]
    d_max = np.zeros(32 * n_warps, np.float32)
    idx = 32 * np.arange(n_warps) + np.array([0, 9, 16, 31])
    d_max[idx] = np.inf
    ik = _near_ee_pair(scene, _near_rows(pts.astype(np.float32), d_max, cuda),
                       cuda, True)
    hit = (ik >= 0).cpu().numpy()
    assert hit[idx].all() and hit.sum() == len(idx)


WIDE_MODES = ["closest", "bounded", "any", "any_bounded", "gated", "hinted"]


def _wide_pair(scene, rows, dev, mode, packet=128):
    """The group-walk kernel against its plain version in ``mode``, on the
    same rows (t_max in row 6): returns the kernel's lane ids."""
    gn, grp = _dev(scene.gnodes, dev), _dev(scene.groups, dev)
    p = -(-rows.shape[1] // packet)
    kw = dict(packet=packet, bounded="bounded" in mode,
              mode="any" if mode.startswith("any") else "closest")
    if mode == "gated":
        g = sweep_mod.sweep_gate(_nrec(scene.smem_nodes, dev), rows, packet)
        # every other packet gated off, whatever the sweep says
        g[::2] = 0
        kw["gate"] = g
    if mode == "hinted":
        kw["hints"] = torch.from_numpy(
            _hints(scene.gslot, p, k=5, seed=p)).to(dev)
    before = obs.counted("launch.wide_trace")
    tk, ik = wide_mod.wide_trace(_rec(scene, rows.device), grp, rows,
                                 scene.width, scene.gdepth, **kw)
    assert obs.counted("launch.wide_trace") == before + 1
    tp, ip = wide_mod.wide_trace_plain(gn, grp, rows, scene.width, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(tk), _bits(tp))
    assert torch.equal(ik, ip)
    return ik


def _mixed_rays(a, m, seed, dev, mesh=False):
    """m unsorted rays with a t_max between 0 and 120: on the cube scenes
    half aimed at cubes and half in the reference's random range; over the
    dense mesh from above it, heading down at random angles."""
    rng = np.random.default_rng(seed)
    if mesh:
        o = rng.uniform(-100, 100, (m, 3)).astype(np.float32)
        o[:, 1] = 40.0
        d = rng.normal(size=(m, 3)).astype(np.float32)
        d[:, 1] = -np.abs(d[:, 1])
    else:
        o, d = _rays(a, n=m + m % 2, seed=seed)
        o, d = _shuffled(m, o[:m], d[:m], seed=seed)
    rays = Ray.create(o, d, device=dev)
    tm = torch.from_numpy(rng.uniform(0.0, 120.0, m).astype(np.float32)).to(dev)
    return rays, tm


@pytest.mark.parametrize("mode", WIDE_MODES)
@pytest.mark.parametrize("n", [1, 31, 33, 65537])
@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_wide_kernel_warp_schedule(wide_scenes, cuda, width, n, mode):
    scene, (a, b, c) = wide_scenes[width]
    rays, tm = _mixed_rays(a, 65538, n + width, cuda, mesh=width == 128)
    bound = tm if "bounded" in mode else torch.full_like(tm, np.inf)
    rows = _ray_rows(rays, bound)[:, :n].contiguous()
    ik = _wide_pair(scene, rows, cuda, mode)
    if n > 33:
        assert (ik >= 0).any() and (ik < 0).any()


@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("width", [16, 32, 64])
def test_wide_kernel_one_lane_fires(wide_scenes, cuda, width, mode):
    """One lane of each warp aimed at a cube, the others away from the
    scene: that lane walks and fires leaves alone."""
    scene, (a, b, c) = wide_scenes[width]
    o, d, idx = _one_lane_rows(a, 4, [0, 5, 17, 31])
    rays = Ray.create(o, d, device=cuda)
    rows = _ray_rows(rays, torch.full((len(o),), np.inf, device=cuda))
    ik = _wide_pair(scene, rows, cuda, mode)
    hit = (ik >= 0).cpu().numpy()
    assert hit[idx].all() and hit.sum() == len(idx)


@pytest.mark.parametrize("width", [16, 32, 64])
def test_wide_kernel_any_lanes_finish_early(wide_scenes, cuda, width):
    """Any hit with every even lane aimed at a cube (it finds an occluder
    and stops walking early) and every odd lane a random ray that walks on:
    the warp runs until its last lane is done."""
    scene, (a, b, c) = wide_scenes[width]
    m = 32 * 64
    ao, ad = tb.aimed_rays(a, m, seed=11)
    ro, rd = tb.create_rays(m, seed=tb.seed_state_after(width))
    ao[1::2], ad[1::2] = ro[1::2], rd[1::2]
    rays = Ray.create(ao, ad, device=cuda)
    for t_max in (np.inf, 200.0):
        rows = _ray_rows(rays, torch.full((m,), t_max, device=cuda))
        for mode in ("any", "any_bounded"):
            ik = _wide_pair(scene, rows, cuda, mode, packet=256)
            assert (ik[0::2] >= 0).float().mean() > 0.9


@pytest.fixture(scope="module")
def deep_scene(wide_scenes):
    """The W=16 cube scene's clusters as a chain 14 groups deep."""
    scene, tris = wide_scenes[16]
    return tb.chain_tables(scene, 14), tris


@pytest.mark.parametrize("mode", WIDE_MODES)
def test_wide_kernel_deep_table(deep_scene, cuda, mode):
    scene, (a, b, c) = deep_scene
    assert scene.gdepth == 14
    rays, tm = _mixed_rays(a, 8193, 14, cuda)
    bound = tm if "bounded" in mode else torch.full_like(tm, np.inf)
    ik = _wide_pair(scene, _ray_rows(rays, bound), cuda, mode)
    assert (ik >= 0).any()


@pytest.mark.parametrize("walk", ["wide", "entry_exit"])
@pytest.mark.parametrize("refine", [True, False])
def test_nearest_deep_table(deep_scene, cuda, walk, refine):
    scene, (a, b, c) = deep_scene
    rng = np.random.default_rng(15)
    cen = (a + b + c) / 3.0
    pts = (cen[rng.integers(0, len(cen), 8193)]
           + rng.normal(scale=20.0, size=(8193, 3))).astype(np.float32)
    d_max = np.where(np.arange(8193) % 4 == 0, 10.0, np.inf).astype(np.float32)
    rows = _near_rows(pts, d_max, cuda)
    if walk == "wide":
        ik = _near_pair(scene, rows, cuda, refine)
    else:
        ik = _near_ee_pair(scene, rows, cuda, refine)
    assert (ik >= 0).any()


# ---- the legacy walk with the table's a_lo ----------------------------------

@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("n", [31, 65537])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_cluster_kernel_with_a_lo(cuda, n, relative, order):
    a, b, c = tb.create_n_cubes(500)
    o, d = _rays(a, n=65538)
    if order == "sorted":
        perm = sort_rays(o, d)[0]
        o, d = o[perm], d[perm]
    else:
        o, d = _shuffled(65538, o, d, seed=n)
    o, d = o[:n], d[:n]
    scene = build_cluster_scene(a, b, c, relative=relative)
    assert scene.a_lo.shape == (scene.num_clusters, 3, 128)
    rows = ct_mod.ray_rows(Ray.create(o, d, device=cuda))
    tables = (_dev(scene.smem_nodes, cuda), _dev(scene.smem_cc, cuda),
              _dev(scene.tris_rel, cuda), _dev(scene.a_lo, cuda))
    kw = dict(relative=relative)
    tk, ik = ct_mod.cluster_trace(*tables, rows, **kw)
    tp, ip = ct_mod.cluster_trace_plain(*tables, rows, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(tk), _bits(tp))
    assert torch.equal(ik, ip)
    assert (ik >= 0).any()


def test_table_crack_ray_on_card(cuda):
    """Ray 475904 of bench.py's aimed set on the 120k scene, which the
    stored a' alone leaves in a crack, hits through the card's legacy walk
    as through the CPU's."""
    a, b, c = tb.create_n_cubes(10000)
    ao, ad = tb.aimed_rays(a, 1 << 20)
    scene = build_cluster_scene(a, b, c)
    o, d = ao[475904:475905], ad[475904:475905]
    rays = Ray.create(o, d, device="cpu")
    got = trace_closest_hit(scene, _to(rays, cuda), device=cuda)
    ref = trace_closest_hit(scene, rays, device="cpu")
    _equal(got, ref)
    assert int(ref.shape_id[0]) == 54391


# ---- the sweep gate's exits and the entry/exit walk in lock step -----------
#
# The sweep kernel stops a warp, a block and the blocks of a packet once the
# packet's bit is known; the entry/exit kernel runs a warp's walks in lock
# step and tests their leaves together. Both must still give their plain
# versions' bits: ragged n (one-lane warps and blocks), unsorted rows,
# packets of 128 and 8192, pre-gated packets, packets fired only by their
# last ray, one lane firing alone, any-hit lanes finishing early, hints.

def _sweep_pair(table, packed, rows, dev, packet, pre_gate=None):
    """The sweep kernel against its plain version on the same rows over the
    host ``table``: returns the gate."""
    before = obs.counted("launch.sweep")
    gk = sweep_mod.sweep_gate(_nrec(table, dev), rows, packet, packed=packed,
                              pre_gate=pre_gate)
    assert obs.counted("launch.sweep") == before + 1
    gp = sweep_mod.sweep_gate_plain(_dev(table, dev), rows, packet,
                                    packed=packed, pre_gate=pre_gate)
    torch.cuda.synchronize()
    assert torch.equal(gk, gp)
    return gk


@pytest.fixture(scope="module")
def packed_scenes(wide_scenes):
    """The scenes of ``wide_scenes`` built with packed=True."""
    return {w: build_tight_scene(*tris, leaf_size=w, packed=True)
            for w, (_, tris) in wide_scenes.items()}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("packet", [128, 8192])
@pytest.mark.parametrize("n", [1, 31, 33, 65537])
def test_sweep_kernel_warp_schedule(wide_scenes, packed_scenes, cuda, n,
                                    packet, packed):
    scene, (a, b, c) = wide_scenes[16]
    table = packed_scenes[16].packed_nodes if packed else scene.smem_nodes
    rays, tm = _mixed_rays(a, 65538, n + packet, cuda)
    rows = _ray_rows(rays, tm)[:, :n].contiguous()
    p = -(-n // packet)
    pre = torch.from_numpy(np.resize(np.array([1, 0, 1], np.int32), p))
    for pre_gate in (None, pre.to(cuda)):
        g = _sweep_pair(table, packed, rows, cuda, packet, pre_gate)
    if n > 33:
        assert g.any()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("packet", [128, 8192])
def test_sweep_fired_only_by_last_ray(wide_scenes, packed_scenes, cuda,
                                      packet, packed):
    """Packets whose only firing ray is their last one (in the packet's
    last block and warp, the last packet ragged) and packets with none:
    no exit may drop a bit or set one."""
    scene, (a, b, c) = wide_scenes[16]
    table = packed_scenes[16].packed_nodes if packed else scene.smem_nodes
    n = 5 * packet + 77
    o, d = tb.create_rays(n, seed=tb.seed_state_after(31))
    inf = torch.full((n,), float("inf"), device=cuda)
    tab = _dev(table, cuda)

    def own_bits(o, d):
        rows = _ray_rows(Ray.create(o, d, device=cuda), inf)
        return rows, sweep_mod.sweep_gate_plain(tab, rows, 1, packed=packed)

    # the random rays that reach a leaf box leave the scene instead
    _, own = own_bits(o, d)
    away = own.bool().cpu().numpy()
    o[away], d[away] = 3e5, np.array([1.0, 0.5, 0.25], np.float32)
    last = np.array([packet - 1, 3 * packet - 1, 4 * packet - 1, n - 1])
    o[last], d[last] = tb.aimed_rays(a, len(last), seed=9)
    rows, own = own_bits(o, d)
    fired = np.nonzero(own.cpu().numpy())[0]
    assert set(fired) <= set(last) and len(fired) >= 3
    g = _sweep_pair(table, packed, rows, cuda, packet)
    want = np.zeros(6, np.int32)
    want[fired // packet] = 1
    assert np.array_equal(g.cpu().numpy(), want)


TIGHT_MODES = ["closest", "bounded", "any", "any_bounded", "gated", "hinted"]


def _tight_pair(scene, rows, dev, mode, packet=128):
    """The entry/exit kernel against its plain version in ``mode``, on the
    same rows (t_max in row 6), over the scene's packed table if it has
    one: returns the kernel's lane ids."""
    packed = scene.packed_nodes is not None
    host = scene.packed_nodes if packed else scene.smem_nodes
    table, rec, grp = _dev(host, dev), _nrec(host, dev), _dev(scene.groups, dev)
    p = -(-rows.shape[1] // packet)
    kw = dict(packed=packed, packet=packet, bounded="bounded" in mode,
              mode="any" if mode.startswith("any") else "closest")
    if mode == "gated":
        g = sweep_mod.sweep_gate(rec, rows, packet, packed=packed)
        # every other packet gated off, whatever the sweep says
        g[::2] = 0
        kw["gate"] = g
    if mode == "hinted":
        leaves = np.nonzero(host[3 if packed else 6] < 0)[0]
        kw["hints"] = torch.from_numpy(_hints(leaves, p, k=5, seed=p)).to(dev)
    before = obs.counted("launch.tight_trace")
    tk, ik = tight_mod.tight_trace(rec, grp, rows, scene.width, **kw)
    assert obs.counted("launch.tight_trace") == before + 1
    tp, ip = tight_mod.tight_trace_plain(table, grp, rows, scene.width, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(tk), _bits(tp))
    assert torch.equal(ik, ip)
    return ik


@pytest.mark.parametrize("mode", TIGHT_MODES)
@pytest.mark.parametrize("n", [1, 31, 33, 65537])
@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_tight_kernel_warp_schedule(wide_scenes, cuda, width, n, mode):
    scene, (a, b, c) = wide_scenes[width]
    rays, tm = _mixed_rays(a, 65538, n + width, cuda, mesh=width == 128)
    bound = tm if "bounded" in mode else torch.full_like(tm, np.inf)
    rows = _ray_rows(rays, bound)[:, :n].contiguous()
    ik = _tight_pair(scene, rows, cuda, mode)
    if n > 33:
        assert (ik >= 0).any() and (ik < 0).any()


@pytest.mark.parametrize("mode", ["closest", "any_bounded", "hinted"])
@pytest.mark.parametrize("n", [1, 33, 65537])
@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_tight_kernel_packed_warp_schedule(wide_scenes, packed_scenes, cuda,
                                           width, n, mode):
    _, (a, b, c) = wide_scenes[width]
    rays, tm = _mixed_rays(a, 65538, n + width, cuda, mesh=width == 128)
    bound = tm if "bounded" in mode else torch.full_like(tm, np.inf)
    rows = _ray_rows(rays, bound)[:, :n].contiguous()
    ik = _tight_pair(packed_scenes[width], rows, cuda, mode)
    if n > 33:
        assert (ik >= 0).any() and (ik < 0).any()


@pytest.mark.parametrize("mode", ["closest", "any", "hinted"])
@pytest.mark.parametrize("width", [16, 32, 64])
def test_tight_kernel_one_lane_fires(wide_scenes, cuda, width, mode):
    """One lane of each warp aimed at a cube, the others away from the
    scene: that lane walks and fires leaves alone (with hints, the whole
    warp also tests the packet's hinted leaves)."""
    scene, (a, b, c) = wide_scenes[width]
    o, d, idx = _one_lane_rows(a, 4, [0, 5, 17, 31])
    rays = Ray.create(o, d, device=cuda)
    rows = _ray_rows(rays, torch.full((len(o),), np.inf, device=cuda))
    ik = _tight_pair(scene, rows, cuda, mode)
    hit = (ik >= 0).cpu().numpy()
    assert hit[idx].all()
    if mode != "hinted":
        assert hit.sum() == len(idx)


@pytest.mark.parametrize("width", [16, 32, 64])
def test_tight_kernel_any_lanes_finish_early(wide_scenes, cuda, width):
    """Any hit with every even lane aimed at a cube (it finds an occluder
    and stops walking early) and every odd lane a random ray that walks on:
    the warp runs until its last lane is done."""
    scene, (a, b, c) = wide_scenes[width]
    m = 32 * 64
    ao, ad = tb.aimed_rays(a, m, seed=11)
    ro, rd = tb.create_rays(m, seed=tb.seed_state_after(width))
    ao[1::2], ad[1::2] = ro[1::2], rd[1::2]
    rays = Ray.create(ao, ad, device=cuda)
    for t_max in (np.inf, 200.0):
        rows = _ray_rows(rays, torch.full((m,), t_max, device=cuda))
        for mode in ("any", "any_bounded", "hinted"):
            ik = _tight_pair(scene, rows, cuda, mode, packet=256)
            assert (ik[0::2] >= 0).float().mean() > 0.9


def test_tight_kernel_deep_table(deep_scene, cuda):
    """The 14-deep chain's entry/exit table, every mode."""
    scene, (a, b, c) = deep_scene
    rays, tm = _mixed_rays(a, 8193, 14, cuda)
    for mode in TIGHT_MODES:
        bound = tm if "bounded" in mode else torch.full_like(tm, np.inf)
        ik = _tight_pair(scene, _ray_rows(rays, bound), cuda, mode)
        assert (ik >= 0).any()


# ---- subtree entry (start_g), the planners, differentiable rendering ------

def _entry_pairs(scene, p, kind, seed):
    """[p, 2] int32 subtree entries on ``scene``'s wide table: random
    groups, nested pairs either way (the second an ancestor of the first,
    or inside it), equal pairs, or all -1; a fifth of the packets get -1
    in one slot or both."""
    parent, depth, _ = wide_group_meta(scene.gnodes)
    real = np.nonzero((parent >= 0) | (np.arange(len(parent)) == 0))[0]
    inner = real[depth[real] >= 1]
    rng = np.random.default_rng(seed)
    sg = rng.choice(real, size=(p, 2))
    if kind == "nested_up":
        sg[:, 0] = rng.choice(inner, p)
        sg[:, 1] = parent[sg[:, 0]]
    elif kind == "nested_down":
        sg[:, 1] = rng.choice(inner, p)
        sg[:, 0] = parent[sg[:, 1]]
    elif kind == "equal":
        sg[:, 1] = sg[:, 0]
    elif kind == "inert":
        sg[:] = -1
    sg[::5, 0] = -1
    sg[2::5] = -1
    return sg.astype(np.int32)


def _start_g_pair(scene, rows, dev, mode, sg, packet):
    """The group-walk kernel with subtree entries ``sg`` against its plain
    version and against the kernel without them: all bit-equal. Returns
    the kernel's lane ids."""
    gn, grp = _dev(scene.gnodes, dev), _dev(scene.groups, dev)
    p = -(-rows.shape[1] // packet)
    kw = dict(packet=packet, bounded=mode == "bounded")
    if mode == "gated":
        g = sweep_mod.sweep_gate(_nrec(scene.smem_nodes, dev), rows, packet)
        g[::2] = 0
        kw["gate"] = g
    if mode == "hinted":
        kw["hints"] = torch.from_numpy(
            _hints(scene.gslot, p, k=5, seed=p)).to(dev)
    start = torch.from_numpy(sg).to(dev)
    before = obs.counted("launch.wide_trace")
    tk, ik = wide_mod.wide_trace(_rec(scene, dev), grp, rows, scene.width,
                                 scene.gdepth, start_g=start, **kw)
    t0, i0 = wide_mod.wide_trace(_rec(scene, dev), grp, rows, scene.width,
                                 scene.gdepth, **kw)
    assert obs.counted("launch.wide_trace") == before + 2
    tp, ip = wide_mod.wide_trace_plain(gn, grp, rows, scene.width,
                                       start_g=start, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(tk), _bits(tp)) and torch.equal(ik, ip)
    assert torch.equal(_bits(tk), _bits(t0)) and torch.equal(ik, i0)
    return ik


@pytest.mark.parametrize("mode", ["closest", "bounded", "gated", "hinted"])
@pytest.mark.parametrize("kind", ["random", "nested_up", "nested_down",
                                  "equal", "inert"])
@pytest.mark.parametrize("packet", [128, 8192])
@pytest.mark.parametrize("width", [16, 128])
def test_wide_kernel_start_g_matches_plain(wide_scenes, cuda, width, packet,
                                           kind, mode):
    """65,537 unsorted rays (a ragged last warp and packet)."""
    scene, (a, b, c) = wide_scenes[width]
    rays, tm = _mixed_rays(a, 65537, packet + width, cuda, mesh=width == 128)
    bound = tm if mode == "bounded" else torch.full_like(tm, np.inf)
    rows = _ray_rows(rays, bound)
    sg = _entry_pairs(scene, -(-65537 // packet), kind, seed=packet + width)
    ik = _start_g_pair(scene, rows, cuda, mode, sg, packet)
    assert (ik >= 0).any() and (ik < 0).any()


@pytest.mark.parametrize("mode", ["closest", "bounded", "gated", "hinted"])
def test_wide_kernel_start_g_deep_table(deep_scene, cuda, mode):
    """The 14-deep chain, entries anywhere on it and nested."""
    scene, (a, b, c) = deep_scene
    rays, tm = _mixed_rays(a, 8193, 15, cuda)
    bound = tm if mode == "bounded" else torch.full_like(tm, np.inf)
    rows = _ray_rows(rays, bound)
    for kind in ("random", "nested_up", "nested_down"):
        sg = _entry_pairs(scene, -(-8193 // 128), kind, seed=len(kind))
        ik = _start_g_pair(scene, rows, cuda, mode, sg, 128)
        assert (ik >= 0).any()


def test_wide_kernel_start_g_warp_schedule(wide_scenes, cuda):
    """n = 1, 31, 33: warps with idle lanes take the phases too."""
    scene, (a, b, c) = wide_scenes[16]
    rays, tm = _mixed_rays(a, 65538, 3, cuda)
    rows = _ray_rows(rays, torch.full_like(tm, np.inf))
    for n in (1, 31, 33):
        sg = _entry_pairs(scene, 1, "nested_up", seed=n)
        sg[0] = np.abs(sg[0])
        _start_g_pair(scene, rows[:, :n].contiguous(), cuda, "closest", sg, 128)


def test_planners_on_card_match_cpu(wide_scenes, cuda):
    """make_seeder, make_planner and make_key_planner on the card give the
    CPU's hints and entries; traced with them, the results are the
    unplanned trace's."""
    scene, (a, b, c) = wide_scenes[16]
    o, d = tb.aimed_rays(a, 16384, seed=5, dist=5.0)
    perm = sort_rays_device(o, d, mode="morton", device=cuda)[0].cpu().numpy()
    o, d = o[perm], d[perm]
    rays = Ray.create(o, d, device=cuda)
    rays_c = _to(rays, "cpu")
    for packet in (512, 8192):
        hk = make_seeder(scene, packet=packet, device=cuda)(rays)
        hc = make_seeder(scene, packet=packet, device="cpu")(rays_c)
        assert torch.equal(hk.cpu(), hc)
        (ph, sg), (phc, sgc) = (
            make_planner(scene, packet=packet, device=dev)(r)
            for dev, r in ((cuda, rays), ("cpu", rays_c)))
        assert torch.equal(ph.cpu(), phc) and torch.equal(sg.cpu(), sgc)
        kg = make_key_planner(scene, packet=packet, device=cuda)(rays.origin)
        kc = make_key_planner(scene, packet=packet, device="cpu")(rays_c.origin)
        assert torch.equal(kg.cpu(), kc)
        base = tuple(x.cpu() for x in trace_closest_hit_tight(
            scene, rays, packet=packet, device=cuda))
        for kw in ({"hints": ph, "start_g": sg}, {"start_g": kg}):
            got = trace_closest_hit_tight(scene, rays, packet=packet,
                                          device=cuda, **kw)
            _equal(got, base)
        seeded = trace_closest_hit_seeded(scene, rays, packet=packet,
                                          device=cuda)
        _equal(seeded, base)


@pytest.mark.parametrize("sweep", [False, True])
def test_key_planned_tracer_on_card(wide_scenes, cuda, sweep):
    scene, tris = wide_scenes[16]
    o, d = _rays(tris[0], n=16384, seed=4)
    kw = dict(packet=512, sweep=sweep, sort="morton", tris=tris, device=cuda)
    _equal(make_tracer(scene, plan="key", **kw)(o, d),
           tuple(x.cpu() for x in make_tracer(scene, **kw)(o, d)))


def _plain_wide(records, groups, rays, width, depth, **kw):
    return wide_mod.wide_trace_plain(wide_mod.wide_table(records), groups,
                                     rays, width, **kw)


@pytest.mark.parametrize("entries", [False, True])
def test_render_depth_gradients_on_card(wide_scenes, cuda, monkeypatch,
                                        entries):
    """render_depth_fast on the card: depth equal, and the a, b, c and
    origin gradients of bench.py's loss within 1e-5 (relative to the
    largest entry), to the same loss with the plain walk as the hard pass
    on the card."""
    scene, tris = wide_scenes[16]
    o, d = _rays(tris[0], n=16384, seed=6)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    target = torch.rand(len(o), generator=torch.Generator().manual_seed(3),
                        dtype=torch.float32).to(cuda) * 60.0
    p = -(-len(o) // 2048)
    sg = (torch.from_numpy(_entry_pairs(scene, p, "random", seed=1))
          if entries else None)

    def run():
        a, b, c, oo = (torch.from_numpy(x).to(cuda).requires_grad_()
                       for x in (*tris, o))
        dd = torch.from_numpy(d).to(cuda)
        depth, hit = render_depth_fast(scene, Ray(oo, dd, 1.0 / dd), a, b, c,
                                       start_g=sg, device=cuda)
        loss = torch.where(hit, (depth - target) ** 2, 0.0).sum() * 1e-9
        loss.backward()
        return depth.detach(), hit, [x.grad for x in (a, b, c, oo)]

    before = obs.counted("launch.wide_trace")
    depth, hit, grads = run()
    assert obs.counted("launch.wide_trace") == before + 1
    monkeypatch.setattr(trace_mod, "wide_trace", _plain_wide)
    depth_p, hit_p, grads_p = run()
    assert torch.equal(hit, hit_p) and torch.equal(_bits(depth), _bits(depth_p))
    assert 0.3 < hit.float().mean() < 0.7
    for g, gp in zip(grads, grads_p):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, gp, rtol=1e-5,
                                   atol=1e-5 * float(gp.abs().max()))


# ---- counting builds (the visit counters) -----------------------------------

def _walk_kw(scene, rows, dev, mode, packet, tight=False):
    """The options of a walk in ``mode`` (closest, bounded, any, gated,
    hinted, start_g) at ``packet``."""
    p = -(-rows.shape[1] // packet)
    kw = dict(packet=packet, bounded=mode in ("bounded", "any"),
              mode="any" if mode == "any" else "closest")
    if mode == "gated":
        g = sweep_mod.sweep_gate(_nrec(scene.smem_nodes, dev), rows, packet)
        g[::2] = 0
        kw["gate"] = g
    if mode == "hinted":
        ids = (np.nonzero(scene.smem_nodes[6] < 0)[0] if tight
               else scene.gslot)
        kw["hints"] = torch.from_numpy(_hints(ids, p, k=5, seed=p)).to(dev)
    if mode == "start_g":
        kw["start_g"] = torch.from_numpy(
            _entry_pairs(scene, p, "random", seed=p)).to(dev)
    return kw


COUNT_MODES = ["closest", "bounded", "any", "gated", "hinted", "start_g"]


@pytest.mark.parametrize("mode", COUNT_MODES)
@pytest.mark.parametrize("packet", [128, 8192])
@pytest.mark.parametrize("width", [16, 128])
def test_wide_counting_build(wide_scenes, cuda, width, packet, mode):
    """The group walk's counting build on 65,537 unsorted rays: t and lanes
    bit-equal to the timed build's, each ray's group tests and fires equal
    to the plain walk's; the timed build's launch count does not move."""
    scene, (a, b, c) = wide_scenes[width]
    rays, tm = _mixed_rays(a, 65537, packet + width, cuda, mesh=width == 128)
    bound = tm if mode in ("bounded", "any") else torch.full_like(tm, np.inf)
    rows = _ray_rows(rays, bound)
    kw = _walk_kw(scene, rows, cuda, mode, packet)
    rec, grp = _rec(scene, cuda), _dev(scene.groups, cuda)
    tk, ik = wide_mod.wide_trace(rec, grp, rows, width, scene.gdepth, **kw)
    before = obs.counted("launch.wide_trace")
    counted = obs.counted("launch.wide_trace_count")
    tc, ic, tests, fires = wide_mod.wide_trace(rec, grp, rows, width,
                                               scene.gdepth, counts=True,
                                               **kw)
    assert obs.counted("launch.wide_trace") == before
    assert obs.counted("launch.wide_trace_count") == counted + 1
    tp, ip, tests_p, fires_p = wide_mod.wide_trace_plain(
        _dev(scene.gnodes, cuda), grp, rows, width, counts=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(tc), _bits(tk)) and torch.equal(ic, ik)
    assert torch.equal(_bits(tc), _bits(tp)) and torch.equal(ic, ip)
    assert tests.dtype == torch.int64
    assert torch.equal(tests, tests_p) and torch.equal(fires, fires_p)
    assert int(fires.sum()) > 0


@pytest.mark.parametrize("mode", ["closest", "bounded", "any", "gated",
                                  "hinted", "packed"])
@pytest.mark.parametrize("width", [16, 128])
def test_tight_counting_build(wide_scenes, packed_scenes, cuda, width, mode):
    """The entry/exit walk's counting build, as the group walk's."""
    scene, (a, b, c) = wide_scenes[width]
    packed = mode == "packed"
    if packed:
        scene = packed_scenes[width]
    rays, tm = _mixed_rays(a, 65537, 3 + width, cuda, mesh=width == 128)
    bound = tm if mode in ("bounded", "any") else torch.full_like(tm, np.inf)
    rows = _ray_rows(rays, bound)
    kw = _walk_kw(scene, rows, cuda, mode, 128, tight=True)
    host = scene.packed_nodes if packed else scene.smem_nodes
    rec, grp = _nrec(host, cuda), _dev(scene.groups, cuda)
    tk, ik = tight_mod.tight_trace(rec, grp, rows, width, packed=packed, **kw)
    before = obs.counted("launch.tight_trace")
    counted = obs.counted("launch.tight_trace_count")
    tc, ic, visits, fires = tight_mod.tight_trace(rec, grp, rows, width,
                                                  packed=packed, counts=True,
                                                  **kw)
    assert obs.counted("launch.tight_trace") == before
    assert obs.counted("launch.tight_trace_count") == counted + 1
    tp, ip, visits_p, fires_p = tight_mod.tight_trace_plain(
        _dev(host, cuda), grp, rows, width, packed=packed, counts=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(tc), _bits(tk)) and torch.equal(ic, ik)
    assert torch.equal(_bits(tc), _bits(tp)) and torch.equal(ic, ip)
    assert torch.equal(visits, visits_p) and torch.equal(fires, fires_p)
    assert int(fires.sum()) > 0


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("walk", ["wide", "entry_exit"])
@pytest.mark.parametrize("width", [16, 128])
def test_nearest_counting_build(wide_scenes, cuda, width, walk, refine):
    """Both nearest walks' counting builds on 65,537 unsorted points (a
    third with a radius): results bit-equal to the timed builds', each
    point's own walk's steps and fires equal to the plain walk's."""
    scene, (a, b, c) = wide_scenes[width]
    rng = np.random.default_rng(width)
    cen = (a + b + c) / 3.0
    m = 65537
    pts = np.concatenate([
        cen[rng.integers(0, len(cen), m // 2)]
        + rng.normal(scale=3.0, size=(m // 2, 3)),
        rng.uniform(a.min(axis=0) - 50, a.max(axis=0) + 50,
                    (m - m // 2, 3))]).astype(np.float32)
    d_max = np.where(np.arange(m) % 3 == 0, 5.0, np.inf).astype(np.float32)
    pts, d_max = _shuffled(m, pts, d_max, seed=width)
    rows = _near_rows(pts, d_max, cuda)
    grp = _dev(scene.groups, cuda)
    if walk == "wide":
        table = _dev(scene.gnodes, cuda)
        args = (scene.gdepth,)
        fn, plain = near_mod.nearest_wide, near_mod.nearest_wide_plain
        name = "wide"
    else:
        table = _dev(scene.smem_nodes, cuda)
        args = ()
        fn = near_mod.nearest_entry_exit
        plain = near_mod.nearest_entry_exit_plain
        name = "entry_exit"
    dk, ik = fn(table, grp, rows, width, *args, refine=refine)
    before = obs.counted(f"launch.nearest_{name}")
    counted = obs.counted(f"launch.nearest_{name}_count")
    dc, ic, steps, fires = fn(table, grp, rows, width, *args, refine=refine,
                              counts=True)
    assert obs.counted(f"launch.nearest_{name}") == before
    assert obs.counted(f"launch.nearest_{name}_count") == counted + 1
    dp, ip, steps_p, fires_p = plain(table, grp, rows, width, refine=refine,
                                     counts=True)
    torch.cuda.synchronize()
    assert torch.equal(_bits(dc), _bits(dk)) and torch.equal(ic, ik)
    assert torch.equal(_bits(dc), _bits(dp)) and torch.equal(ic, ip)
    assert torch.equal(steps, steps_p) and torch.equal(fires, fires_p)


def test_counters_on_card_match_cpu(wide_scenes, cuda):
    """count_visits_* on the card equal the CPU's on the same inputs."""
    scene, (a, b, c) = wide_scenes[16]
    o, d = _rays(a, n=20000, seed=4)
    rays = Ray.create(o, d, device="cpu")
    sg = _entry_pairs(scene, -(-20000 // 2048), "random", seed=4)
    for fn, kw in ((count_visits_wide, {}),
                   (count_visits_wide, {"start_g": sg}),
                   (count_visits_tight, {})):
        _equal(fn(scene, _to(rays, cuda), **kw),
               fn(scene, rays, device="cpu", **kw))
    for wide in (True, False):
        _equal(count_visits_nearest(scene, o, wide=wide),
               count_visits_nearest(scene, o, wide=wide, device="cpu"))


def test_nan_boxes_never_fire_on_card(wide_scenes, cuda):
    """A delta part with no live triangle holds only NaN boxes: on the card
    the group walk, the entry/exit walk and the sweep gate fire nothing
    and test the root alone, the chain's root gate closes every packet,
    and neither nearest walk finds a triangle, each equal to its plain
    version."""
    scene, (a, b, c) = wide_scenes[16]
    ch = make_updater(scene, max_moved=300)(a, b, c,
                                            np.full(300, -1, np.int32))
    delta = ch.parts[1]
    assert bool(torch.isnan(delta.smem_nodes[:6]).all())
    rays, _ = _mixed_rays(a, 4097, 5, cuda)
    rows = _ray_rows(rays, torch.full((4097,), np.inf, device=cuda))
    _, _, tests, fires = wide_mod.wide_trace(
        _rec(delta, cuda), delta.groups, rows, 16, delta.gdepth, counts=True)
    assert int(fires.sum()) == 0 and bool((tests == 1).all())
    _, ik, visits, fires = tight_mod.tight_trace(
        _nrec(delta.smem_nodes, cuda), delta.groups, rows, 16, counts=True)
    assert int(fires.sum()) == 0 and bool((visits == 1).all())
    assert bool((ik == -1).all())
    assert not bool(sweep_mod.sweep_gate(_nrec(delta.smem_nodes, cuda),
                                         rows, 128).any())
    assert not bool(trace_mod._part_root_gate(rows, delta.smem_nodes[:6, 0],
                                              rows[6], 128).any())
    pts = torch.from_numpy(np.concatenate([a, b])[::7].copy()).to(cuda)
    prow = near_mod.point_rows(pts, None)
    for walk in ("wide", "entry_exit"):
        table = delta.gnodes if walk == "wide" else delta.smem_nodes
        fn = getattr(near_mod, f"nearest_{walk}")
        args = (delta.gdepth,) if walk == "wide" else ()
        d2, ik, _, fires = fn(table, delta.groups, prow, 16, *args,
                              counts=True)
        assert int(fires.sum()) == 0 and bool((ik == -1).all())
        assert bool(torch.isinf(d2).all())
    # the seed finds no child to take: the root's test alone, no bound
    seeded = prow.clone()
    tests = near_mod.nearest_seed(delta.gnodes, seeded, counts=True)
    assert bool((tests == 1).all()) and torch.equal(seeded, prow)


# ---- device builds, refits and updates on the card --------------------------

def _tables_equal(sc_k, sc_c):
    """Two TightScenes' tensor tables bit for bit (NaN in place), the
    other fields equal."""
    for name in sc_k._fields:
        x, y = getattr(sc_k, name), getattr(sc_c, name)
        if torch.is_tensor(x) or torch.is_tensor(y):
            x, y = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
            assert torch.equal(_bits(x), _bits(y)), name
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y, equal_nan=True), name
        else:
            assert x == y, name


@pytest.mark.parametrize("kw", [{}, {"upper": "lbvh"}, {"bmat": True},
                                {"width": 32}])
def test_device_build_on_card_matches_cpu(cuda, kw):
    cubes = tb.create_n_cubes(500)
    a, b, c = (x[:5990] for x in cubes)  # not a multiple of 16
    sc_k = build_tight_scene_device(a, b, c, **kw)
    assert sc_k.groups.device.type == "cuda"
    _tables_equal(sc_k, build_tight_scene_device(a, b, c, device="cpu", **kw))
    o, d = _rays(cubes[0], n=8192, seed=2)
    rays = Ray.create(o, d, device="cpu")
    _equal(trace_closest_hit_tight(sc_k, _to(rays, cuda)),
           trace_closest_hit_tight(
               build_tight_scene_device(a, b, c, device="cpu", **kw), rays,
               device="cpu"))


def test_device_chained_build_on_card_matches_cpu(cuda):
    a, b, c = tb.create_n_cubes(500)
    ch_k = build_chained_scene_device(a, b, c, max_part=2000)
    ch_c = build_chained_scene_device(a, b, c, max_part=2000, device="cpu")
    assert len(ch_k.parts) == 3
    for pk, pc in zip(ch_k.parts, ch_c.parts):
        _tables_equal(pk, pc)
    for ik, ic in zip(ch_k.orig_ids, ch_c.orig_ids):
        assert torch.equal(ik.cpu(), ic)
    o, d = _rays(a, n=8192, seed=3)
    rays = Ray.create(o, d, device="cpu")
    _equal(trace_closest_hit_chained(ch_k, _to(rays, cuda)),
           trace_closest_hit_chained(ch_c, rays, device="cpu"))


@pytest.mark.parametrize("bmat", [False, True])
def test_refitter_on_card_matches_cpu(cuda, bmat):
    a, b, c = tb.create_n_cubes(500)
    scene = build_tight_scene(a, b, c, bmat=bmat)
    a2, b2, c2, _ = tb.randomly_transform_scene(a, b, c, len(a) // 2, seed=9)
    re_k = make_refitter(scene)(a2, b2, c2)
    re_c = make_refitter(scene, device="cpu")(a2, b2, c2)
    _tables_equal(re_k, re_c)
    o, d = _rays(a2, n=8192, seed=5)
    rays = Ray.create(o, d, device="cpu")
    _equal(trace_closest_hit_tight(re_k, _to(rays, cuda)),
           trace_closest_hit_tight(re_c, rays, device="cpu"))


@pytest.mark.parametrize("case", ["update", "growth", "chained"])
def test_updater_on_card_matches_cpu(cuda, case):
    a, b, c = tb.create_n_cubes(500)
    n = a.shape[0]
    rng = np.random.default_rng(13)
    a2, b2, c2, moved = tb.randomly_transform_scene(a, b, c, 600, seed=13)
    ids = np.full(700, -1, np.int32)
    ids[:600] = moved[:600]
    alive = None
    if case == "chained":
        scene = build_chained_scene(a, b, c, max_part=2500)
        upd = (make_chained_updater(scene, max_moved=700),
               make_chained_updater(scene, max_moved=700, device="cpu"))
    else:
        scene = build_tight_scene(a, b, c)
        extra = 0 if case == "update" else 100
        upd = (make_updater(scene, max_moved=600, max_added=extra + 100),
               make_updater(scene, max_moved=600, max_added=extra + 100,
                            device="cpu"))
        if case == "growth":
            new = [x[:100] + np.float32(3.0) for x in (a, b, c)]
            a2, b2, c2 = (np.concatenate([x, y]) for x, y in
                          zip((a2, b2, c2), new))
            ids[600:] = np.arange(n, n + 100)
            alive = rng.random(700) < 0.9
    args = (a2, b2, c2, ids) + (() if alive is None else (alive,))
    ch_k, ch_c = upd[0](*args), upd[1](*args)
    assert len(ch_k.parts) == len(ch_c.parts)
    for pk, pc in zip(ch_k.parts, ch_c.parts):
        _tables_equal(pk, pc)
    for ik, ic in zip(ch_k.orig_ids, ch_c.orig_ids):
        assert torch.equal(torch.as_tensor(ik).cpu(), torch.as_tensor(ic))
    o, d = _rays(a, n=8192, seed=7)
    rays = Ray.create(o, d, device="cpu")
    _equal(trace_closest_hit_chained(ch_k, _to(rays, cuda)),
           trace_closest_hit_chained(ch_c, rays, device="cpu"))
    tm = torch.full((8192,), 60.0)
    _equal(trace_any_hit_chained(ch_k, _to(rays, cuda), t_max=tm.to(cuda)),
           trace_any_hit_chained(ch_c, rays, t_max=tm, device="cpu"))
    pts = np.concatenate([a2, b2])[::11]
    _equal(nearest_chained(ch_k, pts), nearest_chained(ch_c, pts,
                                                       device="cpu"))


# ---- the exact cluster frame (FRAME builds) ---------------------------------

@pytest.fixture(scope="module")
def frame_scenes(cuda):
    """Device grid builds of create_n_cubes(300) at W=16 and W=128 (tables
    copied to numpy; Morton clusters span distant cubes, so frame origins
    lie up to ~1e5 from their triangles), with 65,537 unsorted rays from
    [-60, 60]^3 aimed at centroids ~1e5 away (a quarter turned away) and a
    t_max between 0 and 2e5."""
    a, b, c = tb.create_n_cubes(300)
    rng = np.random.default_rng(17)
    m = 65537
    o = rng.uniform(-60.0, 60.0, (m, 3)).astype(np.float32)
    d = (((a + b + c) / np.float32(3))[rng.integers(0, len(a), m)]
         - o).astype(np.float32)
    d[::4] = -d[::4]
    rays = Ray.create(o, d, device=cuda)
    tm = torch.from_numpy(rng.uniform(0.0, 2e5, m).astype(np.float32)).to(cuda)
    out = {}
    for width in (16, 128):
        sc = build_tight_scene_device(a, b, c, width=width, device="cpu")
        sc = sc._replace(**{f: getattr(sc, f).numpy() for f in
                            ("smem_nodes", "groups", "tri_map", "gnodes",
                             "gslot", "a_lo")})
        out[width] = sc
    return out, rays, tm


FRAME_CASES = [(walk, mode) for walk in ("wide", "tight")
               for mode in ("closest", "bounded", "any", "gated", "hinted",
                            "count")] + [("wide", "start_g")]


@pytest.mark.parametrize("walk,mode", FRAME_CASES)
@pytest.mark.parametrize("width", [16, 128])
def test_frame_build_matches_plain(frame_scenes, cuda, width, walk, mode):
    """The FRAME builds of the group walk and the entry/exit walk (a scene's
    ``a_lo`` given) bit-equal to their plain versions with the same
    ``a_lo``, in every mode and in the counting builds; a timed FRAME
    launch is counted in ``launch.<kernel>.frame``."""
    scenes, rays, tm = frame_scenes
    scene = scenes[width]
    tight = walk == "tight"
    bound = tm if mode in ("bounded", "any") else torch.full_like(tm, np.inf)
    rows = _ray_rows(rays, bound)
    kw = _walk_kw(scene, rows, cuda, "closest" if mode == "count" else mode,
                  128, tight=tight)
    counts = mode == "count"
    a_lo, grp = _dev(scene.a_lo, cuda), _dev(scene.groups, cuda)
    frame = f"launch.{'tight' if tight else 'wide'}_trace.frame"
    before = obs.counted(frame)
    if tight:
        got = tight_mod.tight_trace(_nrec(scene.smem_nodes, cuda), grp, rows,
                                    width, counts=counts, a_lo=a_lo, **kw)
        want = tight_mod.tight_trace_plain(_dev(scene.smem_nodes, cuda), grp,
                                           rows, width, counts=counts,
                                           a_lo=a_lo, **kw)
    else:
        got = wide_mod.wide_trace(_rec(scene, cuda), grp, rows, width,
                                  scene.gdepth, counts=counts, a_lo=a_lo,
                                  **kw)
        want = wide_mod.wide_trace_plain(_dev(scene.gnodes, cuda), grp, rows,
                                         width, counts=counts, a_lo=a_lo,
                                         **kw)
    torch.cuda.synchronize()
    assert obs.counted(frame) == before + (0 if counts else 1)
    for x, y in zip(got, want):
        assert torch.equal(_bits(x), _bits(y))
    assert bool(torch.isfinite(got[0]).any())
    if mode == "closest":
        # the exact frame changes results on these rays
        if tight:
            t0, _ = tight_mod.tight_trace(_nrec(scene.smem_nodes, cuda), grp,
                                          rows, width, **kw)
        else:
            t0, _ = wide_mod.wide_trace(_rec(scene, cuda), grp, rows, width,
                                        scene.gdepth, **kw)
        assert not torch.equal(_bits(t0), _bits(got[0]))


def test_frame_build_shared_edges(cuda):
    """The shared-edge case of the far frame (a device grid build of
    create_n_cubes(500), 8,192 rays aimed at centroids ~1e5 away, a
    quarter turned away, seed 17: chip_smoke.py's far_aimed_rays): both
    walks' FRAME builds, timed and counting, bit-equal to their plain
    versions, and rays 374, 2843 and 4003 hit triangles 1365, 2960 and
    468, which the float32 form of tv and w missed."""
    a, b, c = tb.create_n_cubes(500)
    rng = np.random.default_rng(17)
    o = rng.uniform(-60.0, 60.0, (8192, 3)).astype(np.float32)
    d = (((a + b + c) / np.float32(3))[rng.integers(0, len(a), 8192)]
         - o).astype(np.float32)
    d[::4] = -d[::4]
    sc = build_tight_scene_device(a, b, c, device="cpu")
    rows = _ray_rows(Ray.create(o, d, device=cuda),
                     torch.full((8192,), np.inf, device=cuda))
    a_lo, grp = _dev(sc.a_lo, cuda), _dev(sc.groups, cuda)
    for counts in (False, True):
        got_w = wide_mod.wide_trace(_rec(sc, cuda), grp, rows, 16, sc.gdepth,
                                    packet=256, counts=counts, a_lo=a_lo)
        want_w = wide_mod.wide_trace_plain(_dev(sc.gnodes, cuda), grp, rows,
                                           16, packet=256, counts=counts,
                                           a_lo=a_lo)
        got_t = tight_mod.tight_trace(_nrec(sc.smem_nodes, cuda), grp, rows,
                                      16, packet=256, counts=counts,
                                      a_lo=a_lo)
        want_t = tight_mod.tight_trace_plain(_dev(sc.smem_nodes, cuda), grp,
                                             rows, 16, packet=256,
                                             counts=counts, a_lo=a_lo)
        torch.cuda.synchronize()
        for x, y in zip(got_w + got_t, want_w + want_t):
            assert torch.equal(_bits(x), _bits(y))
    tri_map = torch.as_tensor(sc.tri_map).to(cuda)
    for t, lane in (got_w[:2], got_t[:2]):
        ids = [int(tri_map[lane[i].long()]) for i in (374, 2843, 4003)]
        assert bool(torch.isfinite(t[[374, 2843, 4003]]).all())
        assert ids == [1365, 2960, 468]


@pytest.fixture(scope="module")
def host_frame_case(cuda):
    """Host builds of create_n_cubes(500) (the native build, a packed build
    and the legacy ClusterScene, each carrying ``a_lo``) and 8,192 rays
    aimed at centroids ~1e5 from their origins, a quarter turned away
    (seed 17: chip_smoke.py's far_aimed_rays)."""
    a, b, c = tb.create_n_cubes(500)
    rng = np.random.default_rng(17)
    o = rng.uniform(-60.0, 60.0, (8192, 3)).astype(np.float32)
    d = (((a + b + c) / np.float32(3))[rng.integers(0, len(a), 8192)]
         - o).astype(np.float32)
    d[::4] = -d[::4]
    scenes = {"group": build_tight_scene(a, b, c),
              "packed": build_tight_scene(a, b, c, packed=True),
              "legacy": build_cluster_scene(a, b, c)}
    scenes["entry_exit"] = scenes["group"]
    return scenes, Ray.create(o, d, device="cpu")


@pytest.mark.parametrize("walk", ["group", "entry_exit", "packed", "legacy"])
def test_host_frame_far_origins(host_frame_case, cuda, walk):
    """Far ray origins on host builds (ROADMAP queue 3 item 9): the kernel
    the walk launches (the group and entry/exit walks' FRAME builds, the
    legacy walk's float64 leaf test) bit-equal to its plain version on the
    same rows, timed and counting; the entry point on the card equal to the
    CPU's; rays 374, 2843 and 4003 hit (triangles 1365, 2960 and 468 on
    the tight walks), which the rounded frame missed."""
    scenes, rays = host_frame_case
    sc = scenes[walk]
    n = rays.origin.shape[0]
    if walk == "legacy":
        rows = ct_mod.ray_rows(_to(rays, cuda))
        tables = (_dev(sc.smem_nodes, cuda), _dev(sc.smem_cc, cuda),
                  _dev(sc.tris_rel, cuda), _dev(sc.a_lo, cuda))
        got = ct_mod.cluster_trace(*tables, rows)
        want = ct_mod.cluster_trace_plain(*tables, rows)
        run = lambda r, dev: trace_closest_hit(sc, r, device=dev)
    else:
        rows = _ray_rows(_to(rays, cuda), torch.full((n,), np.inf,
                                                     device=cuda))
        a_lo, grp = _dev(sc.a_lo, cuda), _dev(sc.groups, cuda)
        got, want = (), ()
        for counts in (False, True):
            if walk == "group":
                got += wide_mod.wide_trace(_rec(sc, cuda), grp, rows,
                                           sc.width, sc.gdepth, packet=256,
                                           counts=counts, a_lo=a_lo)
                want += wide_mod.wide_trace_plain(
                    _dev(sc.gnodes, cuda), grp, rows, sc.width, packet=256,
                    counts=counts, a_lo=a_lo)
            else:
                table = sc.packed_nodes if walk == "packed" else sc.smem_nodes
                packed = walk == "packed"
                got += tight_mod.tight_trace(_nrec(table, cuda), grp, rows,
                                             sc.width, packed=packed,
                                             packet=256, counts=counts,
                                             a_lo=a_lo)
                want += tight_mod.tight_trace_plain(
                    _dev(table, cuda), grp, rows, sc.width, packed=packed,
                    packet=256, counts=counts, a_lo=a_lo)
        run = lambda r, dev: trace_closest_hit_tight(
            sc, r, packet=256, wide=walk == "group", device=dev)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(_bits(x), _bits(y))
    on_card = run(_to(rays, cuda), cuda)
    _equal(on_card, run(rays, "cpu"))
    named = [374, 2843, 4003]
    assert bool(torch.isfinite(on_card.t[named]).all())
    if walk != "legacy":
        assert on_card.shape_id[named].tolist() == [1365, 2960, 468]


def test_parallel_world1_nccl(cuda):
    """``parallel`` at world size 1 on the card: NCCL over a single-rank
    group (an in-process store); the sharded traces and the depth pass
    equal the unsharded calls bit for bit."""
    import torch.distributed as dist

    from bvh_tpu_torch.bvh import build_sah
    from bvh_tpu_torch.diff import render_depth
    from bvh_tpu_torch.parallel import (make_mesh, shard_scene,
                                        sharded_render_depth,
                                        sharded_trace_any_hit,
                                        sharded_trace_closest_hit)

    a, b, c = tb.create_n_cubes(300)
    o, d = _rays(a, n=8192, seed=6)
    rays = Ray.create(o, d, device=cuda)
    try:
        mesh = make_mesh()
        assert dist.get_backend() == "nccl"
        for sc in (build_tight_scene(a, b, c),
                   build_tight_scene_device(a, b, c, device="cpu")):
            got = sharded_trace_closest_hit(mesh, sc, rays, tris=(a, b, c),
                                            packet=1024)
            want = trace_closest_hit_tight(sc, rays, tris=(a, b, c),
                                           packet=1024)
            for x, y in zip(got, want):
                assert torch.equal(_bits(x), _bits(y))
            tm = torch.where(torch.isfinite(want.t), want.t * 1.2, 100.0)
            assert torch.equal(
                sharded_trace_any_hit(mesh, sc, rays, t_max=tm, packet=1024),
                trace_any_hit_tight(sc, rays, t_max=tm, packet=1024))
        st, sa, sb, sc_ = shard_scene(a, b, c, 1)
        depth, _ = sharded_render_depth(mesh, st, sa, sb, sc_, rays)
        flat = build_sah(*tb.tri_aabbs(a, b, c))[0].to_device(device=cuda)
        ref, _ = render_depth(flat, rays, *(torch.from_numpy(x).to(cuda)
                                            for x in (a, b, c)))
        assert torch.equal(_bits(depth), _bits(ref))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_frame_build_warp_schedule(frame_scenes, cuda, n):
    """Partial warps of the FRAME builds against the plain versions."""
    scenes, rays, tm = frame_scenes
    scene = scenes[16]
    rows = _ray_rows(rays, torch.full_like(tm, np.inf))[:, :n].contiguous()
    a_lo, grp = _dev(scene.a_lo, cuda), _dev(scene.groups, cuda)
    got = wide_mod.wide_trace(_rec(scene, cuda), grp, rows, 16, scene.gdepth,
                              packet=128, a_lo=a_lo)
    want = wide_mod.wide_trace_plain(_dev(scene.gnodes, cuda), grp, rows, 16,
                                     packet=128, a_lo=a_lo)
    got_t = tight_mod.tight_trace(_nrec(scene.smem_nodes, cuda), grp, rows,
                                  16, packet=128, a_lo=a_lo)
    want_t = tight_mod.tight_trace_plain(_dev(scene.smem_nodes, cuda), grp,
                                         rows, 16, packet=128, a_lo=a_lo)
    torch.cuda.synchronize()
    for x, y in zip(got + got_t, want + want_t):
        assert torch.equal(_bits(x), _bits(y))


@pytest.fixture(scope="module")
def frame_points(cuda):
    """Device grid builds of create_n_cubes(300) at W=16 and W=128 (numpy
    tables) and 65,537 unsorted points within a few units of the cubes'
    centres (frame origins up to ~1e5 away), a third with a radius of 2."""
    a, b, c = tb.create_n_cubes(300)
    rng = np.random.default_rng(23)
    m = 65537
    cen = a.reshape(-1, 12, 3).mean(axis=1)
    pts = (cen[rng.integers(0, len(cen), m)]
           + rng.normal(scale=1.5, size=(m, 3))).astype(np.float32)
    d_max = np.where(np.arange(m) % 3 == 0, 2.0, np.inf).astype(np.float32)
    scenes = {}
    for width in (16, 128):
        sc = build_tight_scene_device(a, b, c, width=width, device="cpu")
        scenes[width] = sc._replace(**{f: getattr(sc, f).numpy() for f in
                                       ("smem_nodes", "groups", "gnodes",
                                        "a_lo")})
    return scenes, _near_rows(pts, d_max, cuda)


@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("walk", ["wide", "entry_exit"])
@pytest.mark.parametrize("width", [16, 128])
def test_nearest_frame_build_matches_plain(frame_points, cuda, width, walk,
                                           refine, counts):
    """The FRAME builds of both nearest walks (the scene's ``a_lo`` given)
    bit-equal to their plain versions with the same ``a_lo``, timed and
    counting; a timed FRAME launch is counted in its walk's frame
    counter; the frame changes the squared distances."""
    scenes, rows = frame_points
    scene = scenes[width]
    a_lo, grp = _dev(scene.a_lo, cuda), _dev(scene.groups, cuda)
    if walk == "wide":
        table, extra = _dev(scene.gnodes, cuda), (scene.gdepth,)
        kernel, plain = near_mod.nearest_wide, near_mod.nearest_wide_plain
        counter = "launch.nearest_wide.frame"
    else:
        table, extra = _dev(scene.smem_nodes, cuda), ()
        kernel = near_mod.nearest_entry_exit
        plain = near_mod.nearest_entry_exit_plain
        counter = "launch.nearest_entry_exit.frame"
    before = obs.counted(counter)
    got = kernel(table, grp, rows, width, *extra, refine=refine,
                 counts=counts, a_lo=a_lo)
    want = plain(table, grp, rows, width, refine=refine, counts=counts,
                 a_lo=a_lo)
    torch.cuda.synchronize()
    assert obs.counted(counter) == before + (0 if counts else 1)
    for x, y in zip(got, want):
        assert torch.equal(_bits(x), _bits(y))
    assert bool((got[1] >= 0).any())
    if not counts:
        d0, _ = kernel(table, grp, rows, width, *extra, refine=refine)
        assert not torch.equal(_bits(d0), _bits(got[0]))


@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_nearest_frame_build_warp_schedule(frame_points, cuda, n):
    """Partial warps of both nearest FRAME builds against the plain
    versions."""
    scenes, rows = frame_points
    rows = rows[:, :n].contiguous()
    for width, scene in scenes.items():
        a_lo, grp = _dev(scene.a_lo, cuda), _dev(scene.groups, cuda)
        gn, sn = _dev(scene.gnodes, cuda), _dev(scene.smem_nodes, cuda)
        got = (near_mod.nearest_wide(gn, grp, rows, width, scene.gdepth,
                                     a_lo=a_lo)
               + near_mod.nearest_entry_exit(sn, grp, rows, width, a_lo=a_lo))
        want = (near_mod.nearest_wide_plain(gn, grp, rows, width, a_lo=a_lo)
                + near_mod.nearest_entry_exit_plain(sn, grp, rows, width,
                                                    a_lo=a_lo))
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(_bits(x), _bits(y))


def test_nearest_frame_on_card_matches_cpu(frame_points, cuda):
    """``nearest_tight`` on a device-built scene: the card (FRAME builds)
    equals the CPU bit for bit, in both walks."""
    scenes, rows = frame_points
    pts = rows[:3].T.contiguous()[:8192]
    for scene in scenes.values():
        for wide in (None, False):
            _equal(nearest_tight(scene, pts, wide=wide),
                   nearest_tight(scene, pts.cpu(), wide=wide, device="cpu"))


# ---- the entry/exit walk's broadphase-only build (SKIP) ---------------------

@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("mode", ["closest", "bounded", "gated", "hinted"])
def test_skip_build_matches_plain(case, cuda, mode, counts):
    """The SKIP build (``skip_narrow``) bit-equal to its plain version, its
    visit counts included: every ray misses, no fire is counted, no hint
    is read; a timed launch is counted in ``launch.tight_trace.skip``."""
    scene, _, _, _, rays, tm = case
    bound = tm if mode == "bounded" else torch.full_like(tm, np.inf)
    rows = _ray_rows(rays, bound)
    kw = _walk_kw(scene, rows, cuda, mode, 1024, tight=True)
    grp = _dev(scene.groups, cuda)
    before = obs.counted("launch.tight_trace.skip")
    got = tight_mod.tight_trace(_nrec(scene.smem_nodes, cuda), grp, rows,
                                scene.width, counts=counts, skip_narrow=True,
                                **kw)
    want = tight_mod.tight_trace_plain(_dev(scene.smem_nodes, cuda), grp,
                                       rows, scene.width, counts=counts,
                                       skip_narrow=True, **kw)
    torch.cuda.synchronize()
    skips = obs.counted("launch.tight_trace.skip")
    assert skips == before + (0 if counts else 1)
    for x, y in zip(got, want):
        assert torch.equal(_bits(x), _bits(y))
    assert bool(torch.isinf(got[0]).all()) and bool((got[1] == -1).all())
    if counts:
        assert int(got[2].sum()) > 0 and int(got[3].sum()) == 0


@pytest.mark.parametrize("n", [1, 31, 33, 65537])
def test_skip_build_warp_schedule(wide_scenes, cuda, n):
    """Partial warps of the SKIP build, with counts, against the plain
    version; each ray visits at least as many nodes as the full walk."""
    scene, (a, b, c) = wide_scenes[16]
    o, d = _shuffled(n, *_rays(a, n=2 * n + 2, seed=5))
    rows = _ray_rows(Ray.create(o, d, device=cuda),
                     torch.full((n,), np.inf, device=cuda))
    rec, grp = _nrec(scene.smem_nodes, cuda), _dev(scene.groups, cuda)
    got = tight_mod.tight_trace(rec, grp, rows, 16, packet=128, counts=True,
                                skip_narrow=True)
    want = tight_mod.tight_trace_plain(_dev(scene.smem_nodes, cuda), grp,
                                       rows, 16, packet=128, counts=True,
                                       skip_narrow=True)
    full = tight_mod.tight_trace(rec, grp, rows, 16, packet=128, counts=True)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(_bits(x), _bits(y))
    assert bool((got[2] >= full[2]).all())


def test_skip_narrow_trace_on_card(case, cuda):
    """``trace_closest_hit_tight(skip_narrow=True)`` on the card: the SKIP
    build runs, every ray misses, and the record equals the CPU's."""
    scene, tris, _, _, rays, tm = case
    before = obs.counted("launch.tight_trace.skip")
    got = trace_closest_hit_tight(scene, rays, tris=tris, t_max=tm,
                                  skip_narrow=True, sweep=True)
    torch.cuda.synchronize()
    assert obs.counted("launch.tight_trace.skip") == before + 1
    assert bool(torch.isinf(got.t).all()) and bool((got.shape_id == -1).all())
    _equal(got, trace_closest_hit_tight(scene, _to(rays, "cpu"), tris=tris,
                                        t_max=tm.cpu(), skip_narrow=True,
                                        device="cpu"))


# ---- io: a device build saved, loaded and traced on the card ----------------

def _cpu(out):
    """A query's outputs copied to the CPU (``_equal``'s reference side)."""
    return tuple(x.cpu() for x in out)


def test_device_build_round_trip_on_card(cuda, tmp_path):
    """A grid device build made on the card, saved and loaded (numpy tables,
    ``a_lo`` kept): the loaded scene's traces in both walks and its nearest
    queries run the FRAME builds and equal the card scene's bit for bit;
    a device chain likewise."""
    from bvh_tpu_torch import io as io_t
    a, b, c = tb.create_n_cubes(300)
    tris = tuple(torch.from_numpy(x).to(cuda) for x in (a, b, c))
    scene = build_tight_scene_device(*tris)
    path = str(tmp_path / "device.npz")
    io_t.save_tight_scene(path, scene)
    back = io_t.load_tight_scene(path)
    assert isinstance(back.a_lo, np.ndarray)
    rng = np.random.default_rng(17)
    o = rng.uniform(-60.0, 60.0, (8192, 3)).astype(np.float32)
    d = (((a + b + c) / np.float32(3))[rng.integers(0, len(a), 8192)]
         - o).astype(np.float32)
    rays = Ray.create(o, d, device=cuda)
    for wide in (None, False):
        frame = f"launch.{'wide' if wide is None else 'tight'}_trace.frame"
        before = obs.counted(frame)
        h0 = trace_closest_hit_tight(scene, rays, wide=wide)
        h1 = trace_closest_hit_tight(back, rays, wide=wide)
        torch.cuda.synchronize()
        assert obs.counted(frame) == before + 2
        _equal(h1, _cpu(h0))
    cen = ((a + b + c) / np.float32(3))[np.arange(8192) % len(a)]
    pts = torch.from_numpy(cen + o * np.float32(0.02)).to(cuda)
    before = obs.counted("launch.nearest_wide.frame")
    _equal(nearest_tight(back, pts), _cpu(nearest_tight(scene, pts)))
    assert obs.counted("launch.nearest_wide.frame") == before + 2
    ch = build_chained_scene_device(*tris, max_part=1200)
    io_t.save_chained_scene(str(tmp_path / "chain.npz"), ch)
    ch_back = io_t.load_chained_scene(str(tmp_path / "chain.npz"))
    _equal(trace_closest_hit_chained(ch_back, rays),
           _cpu(trace_closest_hit_chained(ch, rays)))
    _equal(nearest_chained(ch_back, pts), _cpu(nearest_chained(ch, pts)))


# ---- the general pure-tensor path on the card -----------------------------

def test_general_path_on_card_matches_cpu(cuda):
    """The lock-step traversals on the card (each window of steps replayed
    as a captured CUDA graph) against the same calls on the CPU: closest
    hit, any hit, traverse and the ordered walk bit for bit; nearest with
    equal ids outside ties and distances within rtol 1e-6 (the box and
    triangle distances sum over the axes, in another order on the card)."""
    from bvh_tpu_torch import Ball, BallQuery, RayQuery
    from bvh_tpu_torch.bvh import (any_hit_triangles, build_sah,
                                   closest_hit_triangles, nearest_traverse,
                                   nearest_to_triangles, traverse_all)
    a, b, c = tb.create_n_cubes(200)
    flat = build_sah(*tb.tri_aabbs(a, b, c))[0]
    o, d = _rays(a, n=4096, seed=4)
    rays = Ray.create(o, d, device="cpu")
    tris = tuple(torch.from_numpy(x) for x in (a, b, c))
    fc, fk = flat.to_device(device="cpu"), flat.to_device(device=cuda)
    tk = tuple(x.to(cuda) for x in tris)
    rk = _to(rays, cuda)
    hc = closest_hit_triangles(fc, rays, *tris)
    _equal(closest_hit_triangles(fk, rk, *tk), hc)
    tm = torch.where(torch.isfinite(hc.t), hc.t * 0.9, 50.0)
    _equal(any_hit_triangles(fk, rk, *tk, t_max=tm.to(cuda)),
           any_hit_triangles(fc, rays, *tris, t_max=tm))
    _equal(nearest_traverse(fk, rk, max_hits=16),
           nearest_traverse(fc, rays, max_hits=16))
    ball = Ball.create(rays.origin, 40.0, device="cpu")
    _equal(traverse_all(fk, BallQuery(Ball(*(x.to(cuda) for x in ball)))),
           traverse_all(fc, BallQuery(ball)))
    _equal(traverse_all(fk, RayQuery(rk)), traverse_all(fc, RayQuery(rays)))
    pts = rays.origin[:1024]
    sk, dk = nearest_to_triangles(fk, pts.to(cuda), *tk)
    sc, dc = nearest_to_triangles(fc, pts, *tris)
    torch.cuda.synchronize()
    assert torch.allclose(dk.cpu(), dc, rtol=1e-6, atol=0)
    from bvh_tpu_torch import point_triangle_distance_squared as d2
    diff = torch.nonzero(sk.cpu() != sc)[:, 0]
    for s in (sk.cpu()[diff].long(), sc[diff].long()):
        got = d2(pts[diff], *(x[s] for x in tris))
        assert torch.allclose(got, dc[diff] ** 2, rtol=1e-5, atol=0)


# ---- the slab count, the scale legs' walks, the examples' twins -------------
def _slab_inputs(n, nb, dev):
    """``n`` rays (every eighth lying in a box's face plane, the rest half
    aimed at box centres, half reference-random) and ``nb`` boxes of
    create_n_cubes(250)'s triangles, on ``dev``."""
    a, b, c = tb.create_n_cubes(250)
    mn, mx = tb.tri_aabbs(a[:nb], b[:nb], c[:nb])
    o, d = tb.create_rays(n, seed=tb.seed_state_after(250))
    ctr = (mn + mx) * 0.5
    for i in range(n):
        k = i % nb
        if i % 8 == 0:  # in the plane x = box min x, no x component
            o[i] = ctr[k]
            o[i, 0] = mn[k, 0]
            o[i, 2] -= 10.0
            d[i] = (0.0, 0.0, 1.0)
        elif i % 2 == 0:
            d[i] = ctr[k] - o[i]
    rays = Ray.create(o, d, device="cpu")
    return tuple(x.to(dev).contiguous() for x in
                 (rays.origin, rays.inv_direction, torch.from_numpy(mn),
                  torch.from_numpy(mx)))


@pytest.mark.parametrize("nb", [1, 1000, 1001, 2049])
@pytest.mark.parametrize("n", [1, 31, 33, 131072])
def test_slab_count_kernel_matches_plain(cuda, n, nb):
    """The slab count kernel equals its plain version exactly, across the
    block's ragged edge (n), the shared-memory tile's (nb; 2049 takes three
    tiles) and face-plane rays (NaN products, misses)."""
    from bvh_tpu_torch.ops import slab as slab_mod
    o, inv, mn, mx = _slab_inputs(n, nb, cuda)
    before = obs.counted("launch.slab_count")
    got = slab_mod.slab_count(o, inv, mn, mx)
    want = slab_mod.slab_count_plain(o, inv, mn, mx)
    torch.cuda.synchronize()
    assert obs.counted("launch.slab_count") == before + 1
    assert got.dtype == torch.int64 and int(got) == int(want)
    # each face-plane ray misses the box in whose face plane it lies
    own = torch.arange(0, n, 8, device=cuda) % nb
    assert not ray_intersects_aabb(Ray(o[::8], None, inv[::8]), mn[own],
                                   mx[own]).any()


@pytest.mark.parametrize("nc", [100, 1000])
def test_scale_scenes_walks_match_plain(cuda, nc):
    """bench.py's scale scenes (1,200 and 12,000 triangles; wide tables two
    and three levels deep): the sweep gate and the group walk, ungated and
    gated at packet 8192, bit-equal to their plain versions on 65,536 of
    the leg's rays, octmorton-sorted."""
    a, b, c = tb.create_n_cubes(nc)
    scene = build_tight_scene(a, b, c)
    o, d = tb.create_rays(65536, seed=tb.seed_state_after(nc))
    od, dd = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    perm, _ = sort_rays_device(od, dd, mode="octmorton", device=cuda)
    rays = Ray.create(od, dd, device=cuda).take(perm)
    rows = _ray_rows(rays, torch.full((65536,), float("inf"), device=cuda))
    gn, grp = _dev(scene.gnodes, cuda), _dev(scene.groups, cuda)
    gate = sweep_mod.sweep_gate(_nrec(scene.smem_nodes, cuda), rows, 8192)
    assert torch.equal(gate, sweep_mod.sweep_gate_plain(
        _dev(scene.smem_nodes, cuda), rows, 8192))
    for g in (None, gate):
        kw = dict(gate=g, packet=8192)
        got = wide_mod.wide_trace(_rec(scene, cuda), grp, rows, scene.width,
                                  scene.gdepth, **kw)
        want = wide_mod.wide_trace_plain(gn, grp, rows, scene.width, **kw)
        _equal(tuple(x.cpu() for x in got), tuple(x.cpu() for x in want))


@pytest.mark.parametrize("name,argv", [
    ("camera_tracer", ["--size", "64", "--res", "120"]),
    ("dynamic_scene", ["--cubes", "150", "--rays", "4096", "--frames", "3"]),
    ("nearest_query", ["--cubes", "150", "--points", "4096"]),
    ("obj_render", ["--size", "64"]),
    ("pathtrace", ["--size", "64"]),
])
def test_example_twin_on_card(cuda, tmp_path, name, argv):
    """Each twin of ``examples/`` runs on the card by default at a small
    size, launches the port's kernels and passes its own checks."""
    import importlib
    mod = importlib.import_module(f"bvh_tpu_torch.examples.{name}")
    if name in ("camera_tracer", "obj_render", "pathtrace"):
        argv = argv + ["--out", str(tmp_path / "img")]
    walks = ("launch.wide_trace", "launch.tight_trace", "launch.nearest_wide",
             "launch.nearest_entry_exit")
    counts = sum(obs.counted(k) for k in walks)
    res = mod.main(argv)
    assert res["device"].startswith("cuda")
    assert sum(obs.counted(k) for k in walks) > counts
    ok = {"camera_tracer": lambda r: r["plan_equal"],
          "dynamic_scene": lambda r: r["agree"] > 0.99,
          "nearest_query": lambda r: r["brute_ok"] and r["general_ok"],
          "obj_render": lambda r: r["finite"] and r["grad_norm"] > 0,
          "pathtrace": lambda r: r["finite"] and 0 < r["mean_luminance"] < 1}
    assert ok[name](res)
