"""The port's legacy ClusterScene path (build_cluster_scene, sort_rays,
trace_closest_hit and the plain legacy walk) against bvh_tpu (Pallas in
interpret mode), on tests/test_trace_kernel.py's scene: create_n_cubes(30),
360 triangles in 3 clusters, 2,048 aimed rays from 1,000 units away, plus
rays that miss.

Tolerances:

* Scene builds and ray sorts: array-equal.
* Trace vs the reference's ``trace_closest_hit``: hit masks equal; shape
  ids equal outside the near-tie class (the two raw t within one key step,
  2^-16 relative); raw t within the key truncation (2^-16 relative) with
  the reference's reciprocal made exact (``exact_reciprocal``), and within
  2^-8 as shipped (the reference's approximate reciprocal is bfloat16 in
  interpret mode). The port keeps the ray origin in the cluster frame as a
  float pair (``cluster_trace.two_diff``), the reference rounds it once:
  where the pair's low part is not 0, the two raw t may differ by that one
  key step, which the same tolerance holds. The per-ray walk would differ
  from the packet kernel also in the grazing-edge and face-plane classes;
  these rays are aimed away from edges and face planes, so neither occurs
  here.
* With ``tris``: t and u within 1e-4 of the brute-force oracle, as the
  reference's own test (tests/test_trace_kernel.py) holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bvh_tpu
from bvh_tpu.bvh.traverse import brute_force_closest_hit
from bvh_tpu.io.serialize import save_cluster_scene
from bvh_tpu.ops.cluster import build_cluster_scene as build_j
from bvh_tpu.ops.trace import sort_rays as sort_j
from bvh_tpu.ops.trace import trace_closest_hit as trace_j
from bvh_tpu_torch import Ray, ray_intersects_triangle
from bvh_tpu_torch import obs
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import (build_cluster_scene, cluster_scene_from_arrays,
                               sort_rays, trace_closest_hit)
from bvh_tpu_torch.ops import cluster_trace as ct_mod
from bvh_tpu_torch.ops.trace import _dev
from test_torch_scene import reference_native  # noqa: F401  (autouse)

CPU = torch.device("cpu")
KEY_STEP = 2.0 ** -16  # one step of the 7-bit key truncation, relative


@pytest.fixture(scope="module")
def world():
    a, b, c = tb.create_n_cubes(30)
    centers = a.reshape(-1, 12, 3).mean(axis=1)
    idx = np.resize(np.arange(30), 2048)
    orig = (centers[idx] + np.array([800.0, 400.0, -600.0], np.float32))
    aim = centers[idx] + np.array([0.11, 0.07, -0.13], np.float32)
    o_miss = np.full((64, 3), 500000.0, np.float32)
    d_miss = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (64, 1))
    o = np.concatenate([orig, o_miss]).astype(np.float32)
    d = np.concatenate([aim - orig, d_miss]).astype(np.float32)
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


def _assert_scene_equal(sj, st):
    # the reference's fields, then the port's own a_lo
    assert st._fields == sj._fields + ("a_lo",)
    for name in sj._fields:
        x, y = getattr(sj, name), getattr(st, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert np.array_equal(x, y), name
        else:
            assert x == y, name


def _rel(x, y):
    return np.abs(x - y) / np.abs(y)


# ---- scene build and sort ---------------------------------------------------

@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("n_cubes", [30, 53])  # 360 and 636 triangles
def test_build_cluster_scene_equal(relative, n_cubes):
    a, b, c = tb.create_n_cubes(n_cubes, seed=n_cubes)
    assert a.shape[0] % 128  # the last cluster has padding lanes
    sj = build_j(a, b, c, relative=relative)
    st = build_cluster_scene(a, b, c, relative=relative)
    _assert_scene_equal(sj, st)
    assert st.num_tris == a.shape[0]


def test_cluster_scene_from_reference(tmp_path):
    a, b, c = tb.create_n_cubes(20)
    sj = build_j(a, b, c)
    _assert_scene_equal(sj, cluster_scene_from_arrays(sj._asdict()))
    path = tmp_path / "scene.npz"
    save_cluster_scene(str(path), sj)
    with np.load(path) as z:
        _assert_scene_equal(sj, cluster_scene_from_arrays(z))
    with pytest.raises(ValueError, match="newer"):
        cluster_scene_from_arrays({**sj._asdict(), "__version__": 2})
    with pytest.raises(ValueError, match="not ClusterScene fields"):
        cluster_scene_from_arrays({**sj._asdict(), "groups": 0})


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_rays_equal(seed):
    o, d = tb.create_rays(3000, seed=tb.seed_state_after(77 + seed))
    if seed:
        d[::7, 1] = 0.0  # directions on an octant boundary
    pj, ij = sort_j(o, d)
    pt, it = sort_rays(o, d)
    assert np.array_equal(pj, pt) and np.array_equal(ij, it)
    assert np.array_equal(pt[it], np.arange(len(o)))


# ---- the trace ----------------------------------------------------------------

def _check_against_reference(ht, hj, t_tol):
    tr, sr = np.asarray(hj.t), np.asarray(hj.shape_id)
    tp, sp = ht.t.numpy(), ht.shape_id.numpy()
    hit = np.isfinite(tr)
    assert np.array_equal(np.isfinite(tp), hit)
    assert np.array_equal(sp >= 0, hit) and np.array_equal(sr >= 0, hit)
    assert (_rel(tp[hit], tr[hit]) <= t_tol).all()
    # ids differ only in the near-tie class
    diff = hit & (sp != sr)
    assert (_rel(tp[diff], tr[diff]) <= KEY_STEP).all()
    return hit


@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("n", [2112, 1000])  # 1000: not a packet multiple
def test_trace_matches_reference(world, relative, n, exact_reciprocal):
    tris, o, d = world
    o, d = o[-n:], d[-n:]  # the misses are the last 64 rays
    sj = build_j(*tris, relative=relative)
    st = build_cluster_scene(*tris, relative=relative)
    hj = trace_j(sj, bvh_tpu.Ray.create(jnp.asarray(o), jnp.asarray(d)),
                 interpret=True)
    before = obs.counted("launch.cluster_trace")
    ht = trace_closest_hit(st, Ray.create(o, d, device=CPU), device=CPU)
    # the CPU runs the plain version
    assert obs.counted("launch.cluster_trace") == before
    hit = _check_against_reference(ht, hj, KEY_STEP)
    assert 0.9 < hit.mean() < 1.0
    assert (ht.shape_id.numpy()[hit] == np.asarray(hj.shape_id)[hit]).mean() > 0.99


def test_trace_matches_reference_as_shipped(world):
    tris, o, d = world
    hj = trace_j(build_j(*tris), bvh_tpu.Ray.create(jnp.asarray(o),
                                                    jnp.asarray(d)),
                 interpret=True)
    ht = trace_closest_hit(build_cluster_scene(*tris),
                           Ray.create(o, d, device=CPU), device=CPU)
    _check_against_reference(ht, hj, 2.0 ** -8)


@pytest.mark.parametrize("relative", [True, False])
def test_trace_with_tris_matches_brute_force(world, relative):
    tris, o, d = world
    st = build_cluster_scene(*tris, relative=relative)
    got = trace_closest_hit(st, Ray.create(o, d, device=CPU), tris=tris,
                            packet=512, device=CPU)
    rays_j = bvh_tpu.Ray.create(jnp.asarray(o), jnp.asarray(d))
    want = brute_force_closest_hit(rays_j, *(jnp.asarray(x) for x in tris))
    tg, tw = got.t.numpy(), np.asarray(want.t)
    assert np.array_equal(np.isfinite(tg), np.isfinite(tw))
    both = np.isfinite(tg)
    np.testing.assert_allclose(tg[both], tw[both], rtol=1e-4)
    assert (got.shape_id.numpy()[both] == np.asarray(want.shape_id)[both]).all()
    np.testing.assert_allclose(got.u.numpy()[both], np.asarray(want.u)[both],
                               atol=1e-4)
    # the reference's recompute on its own winners gives the same record
    ref = trace_j(build_j(*tris, relative=relative), rays_j,
                  tris=tuple(jnp.asarray(x) for x in tris), interpret=True)
    np.testing.assert_allclose(tg[both], np.asarray(ref.t)[both], rtol=1e-6)


def test_skip_narrow_and_wrapper(world):
    tris, o, d = world
    st = build_cluster_scene(*tris)
    rays = Ray.create(o, d, device=CPU)
    sk = trace_closest_hit(st, rays, skip_narrow=True, device=CPU)
    assert not torch.isfinite(sk.t).any() and (sk.shape_id == -1).all()
    ref = trace_j(build_j(*tris), bvh_tpu.Ray.create(jnp.asarray(o),
                                                     jnp.asarray(d)),
                  interpret=True, skip_narrow=True)
    assert not np.isfinite(np.asarray(ref.t)).any()
    # the wrapper on CPU tensors is the plain version, with the walk's counts
    nodes, cc = _dev(st.smem_nodes, CPU), _dev(st.smem_cc, CPU)
    tris_rel, a_lo = _dev(st.tris_rel, CPU), _dev(st.a_lo, CPU)
    rows = ct_mod.ray_rows(rays)
    t0, i0 = ct_mod.cluster_trace(nodes, cc, tris_rel, a_lo, rows)
    t1, i1, visits, fires = ct_mod.cluster_trace_plain(
        nodes, cc, tris_rel, a_lo, rows, counts=True)
    assert torch.equal(t0.view(torch.int32), t1.view(torch.int32))
    assert torch.equal(i0, i1)
    assert (visits >= 1).all() and (fires <= visits).all() and fires.sum() > 0
    _, _, v_skip, f_skip = ct_mod.cluster_trace_plain(
        nodes, cc, tris_rel, a_lo, rows, skip_narrow=True, counts=True)
    # without leaf tests no bound shrinks, so the walk visits no fewer nodes
    assert (v_skip >= visits).all() and (f_skip >= fires).all()
    with pytest.raises(ValueError, match=r"rays must be \[9, n\]"):
        ct_mod.cluster_trace(nodes, cc, tris_rel, a_lo, rows[:8].contiguous())
    with pytest.raises(ValueError, match="smem_cc"):
        ct_mod.cluster_trace(nodes, cc[:, :1].contiguous(), tris_rel, a_lo,
                             rows)
    with pytest.raises(ValueError, match="multiple of 128"):
        trace_closest_hit(st, rays, packet=200, device=CPU)


def test_face_plane_ray_misses_the_box():
    """A ray lying in a box's face plane gives 0·inf = NaN in the legacy
    slab test, and NaN never fires (the reference's packet kernel can still
    hit through another ray of the packet: the face-plane class)."""
    a, b, c = tb.create_n_cubes(1)
    st = build_cluster_scene(a, b, c)
    ctr = (a + b + c).mean(axis=0) / 3.0
    box_lo = st.smem_nodes[0:3, 0]
    # in the plane x = box min, heading +y at the cube's middle height
    o = np.array([[box_lo[0], ctr[1] - 5.0, ctr[2]]], np.float32)
    d = np.array([[0.0, 1.0, 0.0]], np.float32)
    ht = trace_closest_hit(st, Ray.create(o, d, device=CPU), device=CPU)
    assert not torch.isfinite(ht.t).any()
    # moved off the plane into the cube, the same ray hits
    o[0, 0] += 0.25
    ht = trace_closest_hit(st, Ray.create(o, d, device=CPU), device=CPU)
    assert torch.isfinite(ht.t).all()


@pytest.fixture(scope="module")
def aimed_120k():
    """bench.py's aimed leg on the 120k scene: the triangles, the
    1,048,576 aimed rays and the port's ClusterScene."""
    a, b, c = tb.create_n_cubes(10000)
    ao, ad = tb.aimed_rays(a, 1 << 20)
    return (a, b, c), ao, ad, build_cluster_scene(a, b, c)


def _brute_one(rays, tris):
    """Brute force's closest triangle of one ray: (id, t, u, v)."""
    tt = tuple(torch.from_numpy(x)[None] for x in tris)
    brute = ray_intersects_triangle(Ray(*(x[:, None] for x in rays)), *tt)
    k = int(brute.distance[0].argmin())
    return (k, float(brute.distance[0, k]), float(brute.u[0, k]),
            float(brute.v[0, k]))


def test_crack_ray_at_a_cube_edge(exact_reciprocal, aimed_120k):
    """The one ray of bench.py's aimed set on the 120k scene
    (create_n_cubes(10000), aimed_rays(a, 2**20), ray 805001) that the
    legacy walk missed while brute force hits: triangle 91993, 2^-9
    (barycentric) inside the edge it shares with 92002 on a unit cube.

    The cluster frame rounds the origin: o - cc lies ~3.9e4 from the
    cluster centre, where float32 keeps 2^-8 of a unit, and its z moves by
    2^-9, which puts the ray through that shared edge. There the float32
    edge tests of both triangles round to outside (the crack class). The
    walk keeps the origin as a float pair, o - cc = hi + lo exactly, and
    forms tv = (hi - a') + lo, so it hits 91993 as brute force does. The
    reference's forms round the same table differently and report 92002
    at a t within 1e-5 of the true hit: the grazing-edge class."""
    (a, b, c), ao, ad, st = aimed_120k
    ray = 805001
    o, d = ao[ray:ray + 1], ad[ray:ray + 1]
    rays = Ray.create(o, d, device=CPU)
    k, t_true, u, v = _brute_one(rays, (a, b, c))
    assert k == 91993 and 0.0 < 1.0 - u - v < 3e-3
    # the stored rows, with the origin as o - cc rounds it, put the ray on
    # the edge of both triangles (float64 on the stored values)
    cl = int(np.nonzero(st.tri_map == k)[0][0]) // 128
    o_rel = (rays.origin[0].numpy() - st.smem_cc[:3, cl]).astype(np.float64)
    hi, lo = ct_mod.two_diff(rays.origin[0], torch.from_numpy(st.smem_cc[:3, cl]))
    assert (lo != 0).any()
    dd = rays.direction[0].numpy().astype(np.float64)
    for tid in (91993, 92002):
        lane = int(np.nonzero(st.tri_map == tid)[0][0])
        assert lane // 128 == cl
        rows = st.tris_rel[cl, :9, lane % 128].astype(np.float64)
        ap, e1, e2 = rows[0:3], rows[3:6], rows[6:9]
        tv = o_rel - ap
        p, q = np.cross(dd, e2), np.cross(tv, e1)
        det = p @ e1
        assert abs(1.0 - (tv @ p) / det - (dd @ q) / det) < 1e-6
    ht = trace_closest_hit(st, rays, device=CPU)
    assert int(ht.shape_id[0]) == 91993
    assert abs(float(ht.t[0]) - t_true) <= 2e-4 * t_true
    # the exact recompute on the winner
    hx = trace_closest_hit(st, rays, tris=(a, b, c), device=CPU)
    assert int(hx.shape_id[0]) == 91993
    assert abs(float(hx.t[0]) - t_true) <= 1e-6 * t_true
    hj = trace_j(build_j(a, b, c), bvh_tpu.Ray.create(jnp.asarray(o),
                                                      jnp.asarray(d)),
                 interpret=True)
    assert int(hj.shape_id[0]) == 92002
    assert abs(float(hj.t[0]) - t_true) <= 1e-5 * t_true


@pytest.mark.parametrize("scale", [1e2, 4e4, 1e5])
def test_two_diff_is_exact(scale):
    """The cluster-frame origin's float pair: hi + lo equals o - cc exactly
    (float64 holds the sum and the difference of two float32 values of
    these sizes exactly), hi is the rounded difference, and lo is 0 where
    the difference is exact in float32 (cc = 0, the global frame)."""
    rng = np.random.default_rng(int(scale))
    o = rng.uniform(-scale, scale, 100_000).astype(np.float32)
    cc = rng.uniform(-scale, scale, 100_000).astype(np.float32)
    hi, lo = ct_mod.two_diff(torch.from_numpy(o), torch.from_numpy(cc))
    exact = o.astype(np.float64) - cc.astype(np.float64)
    assert np.array_equal(hi.numpy(), (o - cc).astype(np.float32))
    assert np.array_equal(hi.numpy().astype(np.float64)
                          + lo.numpy().astype(np.float64), exact)
    assert (lo.numpy() != 0).mean() > 0.1
    hi0, lo0 = ct_mod.two_diff(torch.from_numpy(o), torch.zeros(1))
    assert torch.equal(hi0, torch.from_numpy(o)) and not lo0.any()


def test_table_crack_ray_at_a_cube_edge(exact_reciprocal, aimed_120k):
    """A crack in the table, which the exact cluster-frame origin alone
    cannot close: ray 475904 of the same aimed set. Brute force hits
    triangle 54391 2.2e-3 (barycentric) inside an edge. The ClusterScene
    table (array-equal to the reference's) stores a' = a - cc rounded in
    float32, ~4e4 units from the cluster centre, and that rounding moved
    54391's stored a' by 2^-8 in z. With the exact origin, float64 on the
    stored rows puts the ray outside every stored triangle of the cube.
    The scene carries, beside the table, the remainder a_lo = (a - cc) - a'
    of every triangle, and the walk forms tv = ((hi - a') + lo) - a_lo: the
    port's legacy trace hits 54391 at a t within 2e-4 of brute force. The
    reference's forms round the table the other way and report 54394,
    another triangle of the cube, at a t within 1e-4 of the true hit: the
    grazing-edge class."""
    (a, b, c), ao, ad, st = aimed_120k
    ray = 475904
    o, d = ao[ray:ray + 1], ad[ray:ray + 1]
    rays = Ray.create(o, d, device=CPU)
    k, t_true, u, v = _brute_one(rays, (a, b, c))
    assert k == 54391 and 0.0 < v < 3e-3
    dd = d[0].astype(np.float64)
    cube = k // 12
    for tid in range(12 * cube, 12 * cube + 12):
        lane = int(np.nonzero(st.tri_map == tid)[0][0])
        cl = lane // 128
        rows = st.tris_rel[cl, :9, lane % 128].astype(np.float64)
        ap, e1, e2 = rows[0:3], rows[3:6], rows[6:9]
        tv = o[0].astype(np.float64) - st.smem_cc[:3, cl].astype(np.float64) - ap
        p = np.cross(dd, e2)
        det = p @ e1
        if det < 1e-12:  # back-facing or edge-on
            continue
        q = np.cross(tv, e1)
        uu, vv = (tv @ p) / det, (dd @ q) / det
        assert not (uu >= 0 and vv >= 0 and uu + vv <= 1), tid
        if tid == k:
            assert -3e-3 < vv < 0.0
            a_rel = a[k].astype(np.float64) - st.smem_cc[:3, cl].astype(np.float64)
            assert abs(abs(ap[2] - a_rel[2]) - 2.0 ** -8) < 1e-9
            # a' + a_lo is a - cc exactly, and puts the ray inside 54391
            lo = st.a_lo[cl, :, lane % 128].astype(np.float64)
            assert np.array_equal(ap + lo, a_rel)
            tv = tv - lo
            uu, vv = (tv @ p) / det, (dd @ np.cross(tv, e1)) / det
            assert uu >= 0 and vv >= 0 and uu + vv <= 1
    ht = trace_closest_hit(st, rays, device=CPU)
    assert int(ht.shape_id[0]) == k
    assert abs(float(ht.t[0]) - t_true) <= 2e-4 * t_true
    hx = trace_closest_hit(st, rays, tris=(a, b, c), device=CPU)
    assert int(hx.shape_id[0]) == k
    assert abs(float(hx.t[0]) - t_true) <= 1e-6 * t_true
    hj = trace_j(build_j(a, b, c), bvh_tpu.Ray.create(jnp.asarray(o),
                                                      jnp.asarray(d)),
                 interpret=True)
    assert int(hj.shape_id[0]) == 54394
    assert abs(float(hj.t[0]) - t_true) <= 1e-4 * t_true


@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("n_cubes", [30, 10000])
def test_build_cluster_scene_a_lo(relative, n_cubes):
    """Beside the reference's fields, a built scene carries a_lo [C, 3,
    128]: tris_rel stays array-equal to the reference's, and float64(a')
    + float64(a_lo) is a - cc exactly (float64) on every stored lane; pad
    lanes and the global frame hold 0."""
    a, b, c = tb.create_n_cubes(n_cubes, seed=n_cubes)
    st = build_cluster_scene(a, b, c, relative=relative)
    if n_cubes == 30:
        sj = build_j(a, b, c, relative=relative)
        assert np.array_equal(np.asarray(sj.tris_rel), st.tris_rel)
    C = st.num_clusters
    assert st.a_lo.shape == (C, 3, 128) and st.a_lo.dtype == np.float32
    lanes = st.tri_map.reshape(C, 128)
    real = lanes >= 0
    cc = st.smem_cc[:3].T.astype(np.float64) if relative else np.zeros((C, 3))
    exact = a[lanes.clip(0)].astype(np.float64) - cc[:, None, :]  # [C, 128, 3]
    got = (st.tris_rel[:, 0:3].astype(np.float64)
           + st.a_lo.astype(np.float64)).transpose(0, 2, 1)
    assert np.array_equal(got[real], exact[real])
    assert not st.a_lo.transpose(0, 2, 1)[~real].any()
    if not relative:
        assert not st.a_lo.any()
    elif n_cubes == 10000:
        assert (st.a_lo != 0).any()


def test_scene_from_arrays_traces_as_before(world):
    """A scene carried in from the reference's arrays (no vertices) gets a
    zero a_lo and traces bit for bit as the built scene with its a_lo
    zeroed, whose tests form ((hi - a') + lo) - 0 = (hi - a') + lo, the
    walk without a_lo. A built scene's a_lo survives _replace and a round
    trip through _asdict; a table of the wrong shape is refused."""
    tris, o, d = world
    sj = build_j(*tris)
    sa = cluster_scene_from_arrays(sj._asdict())
    C = sa.num_clusters
    assert sa.a_lo.shape == (C, 3, 128) and sa.a_lo.dtype == np.float32
    assert not sa.a_lo.any()
    st = build_cluster_scene(*tris)
    assert st._replace(relative=True).a_lo is st.a_lo
    back = cluster_scene_from_arrays(st._asdict())
    assert np.array_equal(back.a_lo, st.a_lo) and (st.a_lo != 0).any()
    rays = Ray.create(o, d, device=CPU)
    got = trace_closest_hit(sa, rays, device=CPU)
    zeroed = trace_closest_hit(st._replace(a_lo=np.zeros_like(st.a_lo)),
                               rays, device=CPU)
    assert torch.equal(got.t.view(torch.int32), zeroed.t.view(torch.int32))
    assert torch.equal(got.shape_id, zeroed.shape_id)
    assert torch.isfinite(got.t).any()
    tables = tuple(_dev(x, CPU) for x in (sa.smem_nodes, sa.smem_cc,
                                         sa.tris_rel))
    with pytest.raises(ValueError, match="a_lo"):
        ct_mod.cluster_trace(*tables, torch.zeros(C, 2, 128),
                             ct_mod.ray_rows(rays))
