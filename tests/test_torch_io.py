"""The port's ``bvh_tpu_torch.io`` against ``bvh_tpu.io``, in both
directions, on the same seeded inputs.

* Files: each package reads every file the other writes (``FlatBvh``,
  ``ClusterScene``, ``TightScene`` in its wide, entry/exit, packed, bmat,
  sweep-cut and masked forms, ``ChainedScene``), with every field
  array-equal (dtype, shape, values, NaN boxes in place) to the writer's
  own structure. A file of a newer version raises ``ValueError`` in both.
* The exact-frame table ``a_lo``: a host-built or device-built scene,
  chain or cluster scene keeps it across a save and a load (array-equal),
  and traces and nearest queries on the loaded scene equal those before
  the save bit for bit; a file without it (the reference's) loads with
  zeros.
* OBJ: ``load_obj_triangles`` equals the reference's loader array for
  array on ``examples/obj_render.py``'s colonnade with quads, n-gon caps
  and faces with negative indices; the colonnade loaded, built and traced
  on the CPU against the reference's trace in interpret mode (hit masks
  equal on >= 99% of the rays, t within rtol 1e-5 where both hit, ids
  equal where both hit outside the near-tie class: the winners'
  brute-force t within 1e-5 relative).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bvh_tpu.io as io_j
from bvh_tpu import Ray as RayJ
from bvh_tpu.bvh import build_sah as build_sah_j
from bvh_tpu.diff.camera import camera_rays as camera_rays_j
from bvh_tpu.ops import build_cluster_scene as build_cluster_j
from bvh_tpu.ops import build_tight_scene as build_tight_j
from bvh_tpu.ops.cluster import build_chained_scene as build_chained_j
from bvh_tpu.ops.trace import trace_closest_hit_tight as closest_tight_j
import bvh_tpu_torch.io as io_t
from bvh_tpu_torch import Ray
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.bvh import build_sah
from bvh_tpu_torch.ops import (build_chained_scene, build_chained_scene_device,
                               build_cluster_scene, build_tight_scene,
                               build_tight_scene_device, nearest_chained,
                               nearest_tight, trace_closest_hit,
                               trace_closest_hit_chained,
                               trace_closest_hit_tight)
from test_torch_dynamic import (_aimed, _np, _same, assert_scene_equal,
                                exact_recip)  # noqa: F401  (fixture)
from test_torch_scene import assert_a_lo

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

CPU = torch.device("cpu")


def _fields_equal(x, y) -> None:
    """Two structures' shared fields equal: arrays by dtype, shape and
    value (NaN in place), the rest by value."""
    for name in x._fields:
        if name not in y._fields:
            continue
        u, v = getattr(x, name), getattr(y, name)
        if u is None or v is None:
            assert u is None and v is None, name
        elif isinstance(u, (bool, int)) or isinstance(v, (bool, int)):
            assert u == v, name
        else:
            u, v = _np(u), _np(v)
            assert u.dtype == v.dtype and u.shape == v.shape, name
            assert np.array_equal(u, v, equal_nan=True), name


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bvh_both_directions(tmp_path, writer):
    a, b, c = tb.create_n_cubes(20)
    mn, mx = tb.tri_aabbs(a, b, c)
    path = str(tmp_path / "bvh.npz")
    if writer == "reference":
        flat, s2n = build_sah_j(mn, mx)
        io_j.save_bvh(path, flat, s2n)
        back, s2n2 = io_t.load_bvh(path)
    else:
        flat, s2n = build_sah(mn, mx)
        # a tree on a device is written through the host
        io_t.save_bvh(path, flat.to_device(device=CPU), torch.as_tensor(s2n))
        back, s2n2 = io_j.load_bvh(path)
    _fields_equal(flat, back)
    assert np.array_equal(s2n, s2n2)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cluster_scene_both_directions(tmp_path, writer):
    a, b, c = tb.create_n_cubes(20)
    path = str(tmp_path / "cluster.npz")
    if writer == "reference":
        scene = build_cluster_j(a, b, c)
        io_j.save_cluster_scene(path, scene)
        back = io_t.load_cluster_scene(path)
        # a file without a_lo: zeros
        assert back.a_lo.dtype == np.float32 and not back.a_lo.any()
        assert back.a_lo.shape == (scene.num_clusters, 3, 128)
    else:
        scene = build_cluster_scene(a, b, c)
        assert scene.a_lo.any()
        io_t.save_cluster_scene(path, scene)
        back = io_j.load_cluster_scene(path)
        again = io_t.load_cluster_scene(path)
        _fields_equal(scene, again)
        assert np.array_equal(again.a_lo, scene.a_lo)
    _fields_equal(scene, back)


TIGHT_CASES = {"wide": {}, "entry_exit": {"wide": False},
               "packed": {"packed": True}, "bmat": {"bmat": True},
               "sweep_cut": {"sweep_cut": 4}, "width64": {"leaf_size": 64},
               "masked": {}}


@pytest.mark.parametrize("case", list(TIGHT_CASES))
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tight_scene_both_directions(tmp_path, writer, case):
    a, b, c = tb.create_n_cubes(30)
    path = str(tmp_path / "tight.npz")
    build = build_tight_j if writer == "reference" else build_tight_scene
    scene = build(a, b, c, use_native=False, **TIGHT_CASES[case])
    if case == "masked":
        scene = scene._replace(masked=True)
    if writer == "reference":
        io_j.save_tight_scene(path, scene)
        back = io_t.load_tight_scene(path)
        assert_scene_equal(scene, back)
        assert_a_lo(back)  # a file without a_lo: zeros
    else:
        io_t.save_tight_scene(path, scene)
        back = io_j.load_tight_scene(path)
        assert_scene_equal(back, scene)
        assert_a_lo(scene, a)
        _fields_equal(scene, io_t.load_tight_scene(path))
    assert back.masked == (case == "masked")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_chained_scene_both_directions(tmp_path, writer):
    a, b, c = tb.create_n_cubes(60)
    path = str(tmp_path / "chained.npz")
    build = build_chained_j if writer == "reference" else build_chained_scene
    ch = build(a, b, c, max_part=200, use_native=False)
    assert len(ch.parts) > 1
    if writer == "reference":
        io_j.save_chained_scene(path, ch)
        back = io_t.load_chained_scene(path)
        pairs = zip(ch.parts, back.parts)
    else:
        io_t.save_chained_scene(path, ch)
        back = io_j.load_chained_scene(path)
        pairs = zip(back.parts, ch.parts)
    assert len(back.parts) == len(ch.parts) == len(back.orig_ids)
    again = io_t.load_chained_scene(path)
    for i, (pj, pt) in enumerate(pairs):
        assert_scene_equal(pj, pt)
        if writer == "reference":
            assert_a_lo(pt)  # a file without a_lo: zeros
        else:
            # a port part carries its own vertices' remainder, kept in
            # its file
            assert_a_lo(pt, a[_np(ch.orig_ids[i])])
            assert np.array_equal(again.parts[i].a_lo, pt.a_lo)
    for i0, i1 in zip(ch.orig_ids, back.orig_ids):
        assert np.array_equal(_np(i0), _np(i1))


def _newer(path: str, key: str) -> None:
    """Rewrites the npz at ``path`` with its version ``key`` one above."""
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    payload[key] = np.int64(int(payload[key]) + 1)
    np.savez_compressed(path, **payload)


@pytest.mark.parametrize("what", ["bvh", "cluster", "tight", "chained"])
def test_newer_version_raises(tmp_path, what):
    a, b, c = tb.create_n_cubes(8)
    path = str(tmp_path / f"{what}.npz")
    if what == "bvh":
        io_t.save_bvh(path, build_sah(*tb.tri_aabbs(a, b, c))[0])
        key = "__version__"
    elif what == "cluster":
        io_t.save_cluster_scene(path, build_cluster_scene(a, b, c))
        key = "__version__"
    elif what == "tight":
        io_t.save_tight_scene(path, build_tight_scene(a, b, c,
                                                      use_native=False))
        key = "__tight_version__"
    else:
        io_t.save_chained_scene(path, build_chained_scene(
            a, b, c, max_part=40, use_native=False))
        key = "__chained_version__"
    load_t = getattr(io_t, f"load_{'bvh' if what == 'bvh' else what + '_scene'}")
    load_j = getattr(io_j, load_t.__name__)
    load_t(path)
    _newer(path, key)
    for load in (load_t, load_j):
        with pytest.raises(ValueError, match="newer"):
            load(path)


def _far_rays():
    """``test_torch_dynamic.test_far_frame_rays``' rays over
    create_n_cubes(40): aimed at centroids up to ~1e5 away from
    [-60, 60]^3, every fourth turned away."""
    a, b, c = tb.create_n_cubes(40)
    o, d = _aimed(a, b, c, 512, seed=17)
    d[::4] = -d[::4]
    return (a, b, c), Ray.create(o, d, device=CPU)


def test_device_build_round_trip_keeps_a_lo(tmp_path):
    """A device grid build (tensor tables with ``a_lo``) saved and loaded:
    numpy tables array-equal to the tensors, ``a_lo`` kept, and the
    far-frame rays' traces in both walks and nearest queries equal before
    and after bit for bit; the reference's loader reads the file."""
    (a, b, c), rays = _far_rays()
    st = build_tight_scene_device(a, b, c, device=CPU)
    assert torch.is_tensor(st.a_lo)
    path = str(tmp_path / "device.npz")
    io_t.save_tight_scene(path, st)
    back = io_t.load_tight_scene(path)
    assert isinstance(back.a_lo, np.ndarray)
    _fields_equal(st, back)
    for wide in (None, False):
        before = trace_closest_hit_tight(st, rays, packet=256, wide=wide,
                                         device=CPU)
        after = trace_closest_hit_tight(back, rays, packet=256, wide=wide,
                                        device=CPU)
        assert _same(before, after)
        assert torch.isfinite(after.t).any()
    # points within a few units of the centroids, ~1e5 from the frames
    pts = (a + b + c) / np.float32(3) + rays.origin.numpy()[:len(a)] * 0.05
    for wide in (True, False):
        s0, d0 = nearest_tight(st, pts, wide=wide, device=CPU)
        s1, d1 = nearest_tight(back, pts, wide=wide, device=CPU)
        assert torch.equal(s0, s1)
        assert torch.equal(d0.view(torch.int32), d1.view(torch.int32))
    sj = io_j.load_tight_scene(path)
    assert np.array_equal(np.asarray(sj.groups), _np(st.groups))
    assert not hasattr(sj, "a_lo")


def test_device_chain_round_trip_keeps_a_lo(tmp_path):
    """A device-built chain (tensor parts and tensor ``orig_ids``): every
    part's ``a_lo`` and ids kept, traces and nearest queries unchanged."""
    (a, b, c), rays = _far_rays()
    ch = build_chained_scene_device(a, b, c, max_part=160, device=CPU)
    assert len(ch.parts) > 1 and torch.is_tensor(ch.orig_ids[0])
    path = str(tmp_path / "chain.npz")
    io_t.save_chained_scene(path, ch)
    back = io_t.load_chained_scene(path)
    assert len(back.parts) == len(ch.parts)
    for p0, p1, i0, i1 in zip(ch.parts, back.parts, ch.orig_ids,
                              back.orig_ids):
        assert p1.a_lo is not None
        _fields_equal(p0, p1)
        assert np.array_equal(_np(i0), i1)
    assert _same(trace_closest_hit_chained(ch, rays, packet=256, device=CPU),
                 trace_closest_hit_chained(back, rays, packet=256,
                                           device=CPU))
    pts = rays.origin.numpy()
    s0, d0 = nearest_chained(ch, pts, device=CPU)
    s1, d1 = nearest_chained(back, pts, device=CPU)
    assert torch.equal(s0, s1) and torch.equal(d0, d1)
    cj = io_j.load_chained_scene(path)
    assert len(cj.parts) == len(ch.parts)


def test_cluster_scene_round_trip_traces(tmp_path):
    """A legacy scene's ``a_lo`` kept across a round trip: the legacy walk
    gives the same hits before and after, bit for bit."""
    (a, b, c), rays = _far_rays()
    scene = build_cluster_scene(a, b, c)
    path = str(tmp_path / "legacy.npz")
    io_t.save_cluster_scene(path, scene)
    back = io_t.load_cluster_scene(path)
    assert _same(trace_closest_hit(scene, rays, device=CPU),
                 trace_closest_hit(back, rays, device=CPU))


NEGATIVE_FACES = """
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 1.0 1.0 0.0
v 0.0 1.0 0.0
f -4 -3 -2 -1
f -4//1 -3/2/1 -2
"""


@pytest.fixture(scope="module")
def colonnade(tmp_path_factory):
    """examples/obj_render.py's colonnade (quads and octagon caps) with a
    quad and a triangle by negative indices appended."""
    from obj_render import generate_colonnade_obj

    path = str(tmp_path_factory.mktemp("obj") / "colonnade.obj")
    generate_colonnade_obj(path, n_cols=4)
    with open(path, "a") as fh:
        fh.write(NEGATIVE_FACES)
    return path


def test_obj_matches_reference(colonnade):
    got = io_t.load_obj_triangles(colonnade)
    want = io_j.load_obj_triangles(colonnade)
    assert got[0].shape[0] > 250
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == np.float32
        assert np.array_equal(x, y)
    # the appended quad fans into two triangles and the triangle into one
    assert np.array_equal(got[0][-3:], [[0, 0, 0]] * 3)
    assert np.array_equal(got[2][-3:], [[1, 1, 0], [0, 1, 0], [1, 1, 0]])


def test_obj_end_to_end(colonnade, exact_recip):
    """tests/test_obj_e2e.py's pipeline in the port (load, build, trace on
    the CPU) against the reference's in interpret mode, both with the exact
    winner recompute (the reference's reciprocal made exact)."""
    a, b, c = io_t.load_obj_triangles(colonnade)
    cam = camera_rays_j(np.float32([0.0, 9.0, 16.0]),
                        np.float32([0.0, 2.5, 0.0]),
                        np.float32([0.0, 1.0, 0.0]), 55.0, 32, 32)
    o, d = np.asarray(cam.origin), np.asarray(cam.direction)
    hj = closest_tight_j(build_tight_j(a, b, c, use_native=False),
                         RayJ.create(jnp.asarray(o), jnp.asarray(d)),
                         tris=(a, b, c), packet=128, interpret=True)
    ht = trace_closest_hit_tight(build_tight_scene(a, b, c), Ray.create(
        o, d, device=CPU), packet=128, tris=(a, b, c), device=CPU)
    tj, sj = np.asarray(hj.t), np.asarray(hj.shape_id)
    tt, st = ht.t.numpy(), ht.shape_id.numpy()
    assert np.isfinite(tt).mean() > 0.5
    assert (np.isfinite(tj) == np.isfinite(tt)).mean() >= 0.99
    both = np.isfinite(tj) & np.isfinite(tt)
    np.testing.assert_allclose(tt[both], tj[both], rtol=1e-5)
    differ = np.nonzero(both & (sj != st))[0]
    if differ.size:
        from bvh_tpu.ray import ray_intersects_triangle as hit_j
        rays = RayJ.create(jnp.asarray(o[differ]), jnp.asarray(d[differ]))
        for ids in (sj[differ], st[differ]):
            t = np.asarray(hit_j(rays, jnp.asarray(a[ids]), jnp.asarray(
                b[ids]), jnp.asarray(c[ids])).distance)
            np.testing.assert_allclose(t, tt[differ], rtol=1e-5)
