"""The closest-hit trace's epilogue (``ops/trace.py::_epilogue``) on the
CPU: its plain branch against the composition it replaced (the bound mask,
``_shape_ids``, ``_finish`` and ``_unpermute``, written out here), bit for
bit, over batches with misses, culled and back-facing winners, winners
behind the origin and lane ids at both clamps; a CPU call launches no
kernel; the kernel's wrapper (``ops/epilogue.py::closest_epilogue``)
refuses what it does not take. ``epilogue_case`` and ``composed`` serve
the card's tests too (``tests/test_torch_epilogue_cuda.py``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bvh_tpu_torch import Ray, obs
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import (build_tight_scene, make_tracer,
                               trace_closest_hit_tight)
from bvh_tpu_torch.ops import trace as trace_mod
from bvh_tpu_torch.ops.epilogue import closest_epilogue
from bvh_tpu_torch.ops.trace import _ray_rows

INF = float("inf")


def epilogue_case(n: int, seed: int, bound: str | None, unsort: bool,
                  device="cpu"):
    """The epilogue's inputs for ``n`` rays: ``(scene, rays, rows, tris, t,
    lane_id, tm, bounded, inv)``, made on the CPU and moved to
    ``device``. The scene is a stand-in holding ``tri_map`` (with -1 pads);
    each ray's own triangle lies about 5 ahead of it, front-facing or culled
    (reversed winding), the ray inside or outside it, a few behind the
    origin; the walk's ``t`` is +inf on a fifth of the rays; lane ids point
    at the ray's triangle, at a pad, below 0 or past the map's end.
    ``bound``: None, "scalar" (t_max 5) or "per_ray"; ``unsort``: the
    inverse of a random permutation."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    rays = Ray.create(o, rng.normal(size=(n, 3)).astype(np.float32),
                      device="cpu")
    dn = rays.direction.numpy().astype(np.float64)
    side = rng.normal(size=(n, 3))
    e1 = np.cross(dn, side)
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(dn, e1)
    s = rng.uniform(0.5, 2.0, (n, 1))
    ahead = np.where(rng.random((n, 1)) < 0.05, -5.0, 5.0)  # some behind
    p = o + ahead * dn
    bary = rng.uniform(-0.2, 0.7, (n, 2))
    front = rng.random((n, 1)) < 0.8  # else reversed winding: culled
    eb, ec = np.where(front, e2, e1) * s, np.where(front, e1, e2) * s
    a = p - bary[:, :1] * eb - bary[:, 1:] * ec
    n_tris = n + 7
    order = rng.permutation(n_tris)
    tri = np.zeros((n_tris, 3, 3))
    tri[:, 0] = rng.uniform(-1, 1, (n_tris, 3))  # triangles no ray owns
    tri[:, 1] = tri[:, 0] + [1, 0, 0]
    tri[:, 2] = tri[:, 0] + [0, 1, 0]
    tri[order[:n], 0], tri[order[:n], 1], tri[order[:n], 2] = a, a + eb, a + ec
    tri = tri.astype(np.float32)
    n_map = n_tris + n_tris // 4 + 3
    slots = rng.permutation(n_map)
    tri_map = np.full(n_map, -1, np.int32)
    tri_map[slots[:n_tris]] = np.arange(n_tris)
    lane = slots[order[:n]].astype(np.int32)
    kind = rng.random(n)
    lane[kind < 0.03] = -1  # the low clamp
    lane[(kind >= 0.03) & (kind < 0.06)] = n_map + rng.integers(0, 5)
    pads = slots[n_tris:]
    lane[(kind >= 0.06) & (kind < 0.09)] = pads[0]  # a -1 of the map
    t = (5.0 * (1.0 - 1e-6 * rng.random(n))).astype(np.float32)
    t[rng.random(n) < 0.2] = INF
    if bound == "per_ray":
        tm = rng.uniform(4.0, 6.0, n).astype(np.float32)
    else:
        tm = np.full(n, 5.0 if bound == "scalar" else INF, np.float32)
    t_dev = torch.from_numpy(t)
    rows = _ray_rows(rays, torch.from_numpy(tm))
    inv = None
    if unsort:
        perm = torch.from_numpy(rng.permutation(n))
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(n)
    mv = (lambda x: None if x is None else x.to(device))
    return (SimpleNamespace(tri_map=tri_map), Ray(*(mv(x) for x in rays)),
            mv(rows), tuple(mv(torch.from_numpy(tri[:, k])) for k in range(3)),
            mv(t_dev), mv(torch.from_numpy(lane)), mv(torch.from_numpy(tm)),
            bound is not None, mv(inv))


def composed(scene, rays_s, rows, tris, t, lane_id, tm, bounded, inv=None):
    """The epilogue as the trace entries composed it before the kernel: the
    bound mask, ``_shape_ids``, ``_finish`` over the [n_tris, 9] table and
    ``_unpermute`` by ``inv``."""
    tris9 = None if tris is None else torch.cat(tris, dim=1)
    if bounded:
        t = torch.where(t < tm, t, INF)
    out = trace_mod._finish(rays_s, tris9, t,
                            trace_mod._shape_ids(scene, t, lane_id))
    return out if inv is None else trace_mod._unpermute(out, inv,
                                                        tris9 is not None)


def bits(rec) -> tuple:
    """A ``HitRecord``'s four fields as int32 bit patterns."""
    return tuple(x.view(torch.int32) if x.is_floating_point() else x
                 for x in rec)


def assert_same_bits(got, want) -> None:
    for name, x, y in zip(("t", "u", "v", "shape_id"), bits(got), bits(want)):
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("n", [1, 257])
@pytest.mark.parametrize("unsort", [False, True])
@pytest.mark.parametrize("bound", [None, "scalar", "per_ray"])
@pytest.mark.parametrize("tables", [None, "separate", "table9"])
def test_plain_branch_equals_the_composition(n, unsort, bound, tables):
    """``tables``: none (u = v = 0), (a, b, c), or views of one [n_tris, 9]
    table passed with it (``make_tracer``'s)."""
    scene, rays, rows, tris, *rest = epilogue_case(n, 40 + n, bound, unsort)
    tris9 = None
    if tables is None:
        tris = None
    elif tables == "table9":
        tris9 = torch.cat(tris, dim=1)
        tris = tris9.split(3, dim=1)
    before = obs.counted("launch.trace_epilogue")
    got = trace_mod._epilogue(scene, rays, rows, tris, *rest, tris9=tris9)
    assert obs.counted("launch.trace_epilogue") == before
    assert_same_bits(got, composed(scene, rays, rows, tris, *rest))


def test_the_case_holds_every_class():
    """The cases reach what the kernel must repeat: hits, misses, culled and
    out-of-triangle winners, winners behind the origin, masked hits, ids of
    -1 on finite t, and lane ids past both ends of the map."""
    scene, rays, rows, tris, t, lane, tm, _, _ = epilogue_case(
        4096, 7, "per_ray", False)
    out = composed(scene, rays, rows, tris, t, lane, tm, True)
    hit = torch.isfinite(t) & (t < tm)
    assert (torch.isfinite(out.t) & hit).any() and (~hit).any()
    assert ((out.t == t) & hit & (out.shape_id >= 0)).any()  # rejected
    assert ((out.t != t) & hit).sum() > 300  # recomputed
    assert (hit & (out.shape_id < 0)).any()
    assert (hit & (lane < 0)).any()
    assert (hit & (lane >= scene.tri_map.shape[0])).any()
    assert ((out.u == 0) & (out.v == 0) & hit & (out.shape_id >= 0)).any()


def test_a_cpu_tracer_launches_no_epilogue_kernel():
    a, b, c = tb.create_n_cubes(40)
    o, d = tb.aimed_rays(a, 512, seed=3)
    before = obs.counted("launch.trace_epilogue")
    hit = make_tracer(build_tight_scene(a, b, c), packet=128, sort="morton",
                      tris=(a, b, c), device="cpu")(o, d)
    assert torch.isfinite(hit.t).any()
    assert obs.counted("launch.trace_epilogue") == before


def test_column_major_tables_trace_as_row_major_ones():
    """``trace_closest_hit_tight`` takes (a, b, c) in either memory order
    (the kernel reads a unit column stride; ``_tris_on`` copies the other
    order to it) and gives the same bits."""
    a, b, c = tb.create_n_cubes(40)
    o, d = tb.aimed_rays(a, 512, seed=4)
    scene, rays = build_tight_scene(a, b, c), Ray.create(o, d, device="cpu")
    fortran = tuple(np.asfortranarray(x) for x in (a, b, c))
    assert all(t.stride(1) == 1
               for t in trace_mod._tris_on(fortran, "cpu"))
    got = trace_closest_hit_tight(scene, rays, tris=fortran, packet=128,
                                  device="cpu")
    want = trace_closest_hit_tight(scene, rays, tris=(a, b, c), packet=128,
                                   device="cpu")
    assert torch.isfinite(want.t).any()
    assert_same_bits(got, want)


def refused(fault: str, device="cpu"):
    """``closest_epilogue``'s arguments with one ``fault``."""
    scene, _, rows, tris, t, lane, _, bounded, inv = epilogue_case(
        300, 9, "scalar", True, device)
    tri_map = torch.from_numpy(scene.tri_map).to(device)
    kw = {"tris": tris, "bounded": bounded, "inv": inv}
    if fault == "float64_tris":
        kw["tris"] = tuple(x.double() for x in tris)
    elif fault == "tris_of_four_columns":
        kw["tris"] = tuple(torch.cat([x, x[:, :1]], dim=1) for x in tris)
    elif fault == "tris_of_other_lengths":
        kw["tris"] = (tris[0], tris[1][:-1], tris[2])
    elif fault == "rows_of_twelve":
        rows = rows[:12].contiguous()
    elif fault == "t_float64":
        t = t.double()
    elif fault == "lane_int64":
        lane = lane.long()
    elif fault == "tri_map_int64":
        tri_map = tri_map.long()
    elif fault == "inv_int32":
        kw["inv"] = inv.int()
    elif fault == "inv_short":
        kw["inv"] = inv[:-1]
    elif fault == "rows_transposed":
        rows = rows.t().contiguous().t()
    return (rows, t, lane, tri_map), kw


FAULTS = ["float64_tris", "tris_of_four_columns", "tris_of_other_lengths",
          "rows_of_twelve", "t_float64", "lane_int64", "tri_map_int64",
          "inv_int32", "inv_short", "rows_transposed"]


@pytest.mark.parametrize("fault", FAULTS + [None])
def test_the_kernel_wrapper_refuses_what_it_does_not_take(fault):
    """Every fault raises before any launch; a well-formed CPU call raises
    too (the CPU runs the plain composition, never this wrapper)."""
    args, kw = refused(fault)
    before = obs.counted("launch.trace_epilogue")
    with pytest.raises(ValueError) as err:
        closest_epilogue(*args, **kw)
    assert ("no epilogue kernel" in str(err.value)) == (fault is None)
    assert obs.counted("launch.trace_epilogue") == before
