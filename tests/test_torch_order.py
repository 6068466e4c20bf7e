"""The tracer's coherence order and ray rows (``ops/trace.py``'s sort key,
``_order``, ``_take`` and ``_prologue``; on the card ``ops/order.py``'s
kernels) on the CPU: the plain route against the composition the kernels
replaced, written out here, bit for bit (``perm``, ``inv``, the rows and a
whole ``make_tracer`` call); a CPU call launches no kernel; the kernels'
wrappers refuse what they do not take. ``order_case`` and the written-out
composition serve the card's tests too (``tests/test_torch_order_cuda.py``).
"""

import numpy as np
import pytest
import torch

from bvh_tpu_torch import Ray, obs
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.bvh.lbvh import morton_codes
from bvh_tpu_torch.ops import (build_tight_scene, make_tracer,
                               sort_rays_device, trace_closest_hit_tight)
from bvh_tpu_torch.ops import trace as trace_mod
from bvh_tpu_torch.ops.order import ray_key, ray_rows

# (mode, bits) of every key the tests take
KEYS = [("morton", 6), ("octmorton", 6), ("octant", 2), ("octant", 6)]
CASES = ["random", "aimed", "equal_origins", "flat_axis", "signed_zeros"]


def order_case(n: int, seed: int, case: str, device="cpu"):
    """``(o, d)`` float32 [n, 3], made on the CPU and moved to ``device``:
    uniform origins and directions, the aimed rays of a cube scene, every
    origin the same (the 1e-30 extent clamp), one axis of the origins flat,
    or directions with +0.0 and -0.0 components (and a few zero
    directions)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if case == "aimed":
        a, _, _ = tb.create_n_cubes(40)
        o, d = tb.aimed_rays(a, n, seed=seed)
    elif case == "equal_origins":
        o[:] = o[0]
    elif case == "flat_axis":
        o[:, 1] = np.float32(3.25)
    elif case == "signed_zeros":
        zero = rng.random((n, 3)) < 0.4
        d[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
        o[rng.random((n, 3)) < 0.1] = -0.0
    return (torch.from_numpy(np.ascontiguousarray(o)).to(device),
            torch.from_numpy(np.ascontiguousarray(d)).to(device))


def key_composed(o, d, bits: int, mode: str) -> torch.Tensor:
    """The sort key as ``sort_rays_device`` composed it before the
    kernels."""
    octant = ((d[:, 0] > 0).to(torch.int32) * 4
              + (d[:, 1] > 0).to(torch.int32) * 2
              + (d[:, 2] > 0).to(torch.int32))
    lo = o.amin(dim=0)
    hi = o.amax(dim=0)
    if mode == "morton":
        return ((morton_codes(o, lo, hi) >> 3) << 3) | octant
    if mode == "octmorton":
        return (octant << 27) | (morton_codes(o, lo, hi) >> 3)
    scale = (2.0 ** bits - 1.0) / torch.clamp_min(hi - lo, 1e-30)
    q = ((o - lo) * scale).to(torch.int32)
    return ((octant << (3 * bits)) | (q[:, 0] << (2 * bits))
            | (q[:, 1] << bits) | q[:, 2])


def order_composed(o, d, bits: int, mode: str):
    """``(perm, inv)``: the stable argsort of the key and its inverse by a
    scatter."""
    perm = torch.argsort(key_composed(o, d, bits, mode), stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv


def rows_composed(o, d, perm=None) -> torch.Tensor:
    """The walk's ray rows of the rays taken by ``perm``: ``Ray.create``,
    then the clamp, the product and the stack of ``_ray_rows``."""
    if perm is not None:
        o, d = o[perm], d[perm]
    rays = Ray.create(o, d, device=o.device)
    inv_c = torch.clamp(rays.inv_direction, -1.0e30, 1.0e30)
    tm = torch.full((o.shape[0],), float("inf"), device=o.device)
    return torch.stack([*(rays.origin * inv_c).unbind(1), *inv_c.unbind(1),
                        tm, *rays.direction.unbind(1),
                        *rays.origin.unbind(1)])


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    if x.is_floating_point():
        x, y = x.view(torch.int32), y.view(torch.int32)
    return x.dtype == y.dtype and torch.equal(x, y)


def launches() -> tuple:
    return obs.counted("launch.ray_key"), obs.counted("launch.ray_rows")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode,bits", KEYS)
def test_plain_order_equals_the_composition(case, mode, bits):
    o, d = order_case(1000, 3, case)
    before = launches()
    key = trace_mod._sort_key(o, d, bits, mode)
    perm, inv = sort_rays_device(o, d, bits=bits, mode=mode, device="cpu")
    assert launches() == before
    want = order_composed(o, d, bits, mode)
    assert same_bits(key, key_composed(o, d, bits, mode))
    assert same_bits(perm, want[0]) and same_bits(inv, want[1])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("sorted_", [True, False])
def test_plain_rows_equal_the_composition(case, sorted_):
    """``_sorted_rows`` on the CPU (``_inverse``, ``_take``, ``Ray.create``
    and ``_prologue``) against the composition; ``_rays_of_rows`` reads
    back the sorted rays that ``Ray.create`` makes, the inverse clamped."""
    o, d = order_case(700, 5, case)
    perm, want_inv = (order_composed(o, d, 6, "morton") if sorted_
                      else (None, None))
    before = launches()
    rows, inv = trace_mod._sorted_rows(o, d, perm)
    assert launches() == before
    assert same_bits(rows, rows_composed(o, d, perm))
    assert (inv is None) == (perm is None)
    if perm is not None:
        assert same_bits(inv, want_inv)
    rays = Ray.create(*((o, d) if perm is None else (o[perm], d[perm])),
                      device="cpu")
    back = trace_mod._rays_of_rows(rows)
    assert same_bits(back.origin, rays.origin)
    assert same_bits(back.direction, rays.direction)
    assert same_bits(back.inv_direction,
                     torch.clamp(rays.inv_direction, -1.0e30, 1.0e30))


def test_the_cases_reach_the_edges():
    """Equal origins take the extent's clamp (every key one cell), a flat
    axis one cell on that axis, and the signed zeros' octants and
    reciprocals differ only in sign (0 > 0 and -0 > 0 are both false)."""
    o, d = order_case(500, 1, "equal_origins")
    assert (key_composed(o, d, 6, "morton") >> 3).unique().numel() == 1
    o, d = order_case(500, 1, "flat_axis")
    assert (o.amax(0) - o.amin(0))[1] == 0
    o, d = order_case(500, 1, "signed_zeros")
    zeros = d == 0
    neg = torch.signbit(d) & zeros
    assert neg.any() and (zeros & ~neg).any() and (d == 0).all(1).any()
    rows = rows_composed(o, d)
    inv_c = rows[3:6].t()
    assert (inv_c[zeros & ~neg] == 1e30).any()
    assert (inv_c[neg] == -1e30).any()


@pytest.mark.parametrize("sort", ["morton", "octmorton", "octant", None])
@pytest.mark.parametrize("exact", [True, False])
def test_a_cpu_tracer_equals_the_composed_trace(sort, exact):
    """``make_tracer``'s plain route against ``trace_closest_hit_tight`` on
    the rays the composition sorts, un-sorted by its ``inv``; no kernel is
    counted."""
    a, b, c = tb.create_n_cubes(40)
    o, d = tb.aimed_rays(a, 1500, seed=8)
    o[::3], d[::3] = tb.create_rays(500, seed=9)
    scene = build_tight_scene(a, b, c)
    tris = (a, b, c) if exact else None
    before = launches()
    got = make_tracer(scene, packet=256, sort=sort, bits=2, tris=tris,
                      device="cpu")(o, d)
    assert launches() == before
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    perm = inv = None
    if sort is not None:
        perm, inv = order_composed(ot, dt, 2, sort)
    want = trace_closest_hit_tight(scene, Ray.create(ot, dt, device="cpu"),
                                   tris=tris, packet=256, sweep=True,
                                   perm=perm, device="cpu")
    if inv is not None:
        want = type(want)(*(x[inv] for x in want))
    assert torch.isfinite(want.t).sum() > 500
    for x, y in zip(got, want):
        assert same_bits(x, y)


def test_a_cpu_tracer_carries_the_rays_gradient():
    """An unsorted tracer with ``tris`` recomputes its winners from the rays
    as views of the plain rows: the hits and the gradient of their (t, u,
    v) by the origins and directions are, bit for bit, those of
    ``trace_closest_hit_tight``. (A sorted call's un-sort moves bit
    patterns, so it carries no gradient, as before the kernels.)"""
    a, b, c = tb.create_n_cubes(40)
    o, d = tb.aimed_rays(a, 1200, seed=8)
    scene = build_tight_scene(a, b, c)

    def grads(trace):
        ot = torch.from_numpy(o).requires_grad_(True)
        dt = torch.from_numpy(d).requires_grad_(True)
        out = trace(ot, dt)
        hit = torch.isfinite(out.t)
        loss = torch.where(hit, out.t + out.u + out.v, 0.0).sum()
        return (out, *torch.autograd.grad(loss, (ot, dt)))

    got = grads(make_tracer(scene, packet=256, sort=None, tris=(a, b, c),
                            device="cpu"))
    want = grads(lambda ot, dt: trace_closest_hit_tight(
        scene, Ray.create(ot, dt, device="cpu"), tris=(a, b, c), packet=256,
        sweep=True, device="cpu"))
    assert torch.isfinite(want[0].t).sum() > 1000
    for x, y in zip(got[0], want[0]):
        assert same_bits(x.detach(), y.detach())
    for x, y in zip(got[1:], want[1:]):
        assert torch.isfinite(x).all() and (x != 0).any()
        assert same_bits(x, y)
    sorted_ = make_tracer(scene, packet=256, sort="morton", tris=(a, b, c),
                          device="cpu")
    ot = torch.from_numpy(o).requires_grad_(True)
    assert not sorted_(ot, d).t.requires_grad


def test_a_planned_cpu_tracer_reads_the_origin_rows():
    """``plan="key"`` plans from rows 10-12 (a strided view of the rows),
    with a ragged last packet and without one: the plan and the hits are
    the unplanned tracer's."""
    a, b, c = tb.create_n_cubes(200)
    scene = build_tight_scene(a, b, c)
    for n in (4096, 4000):
        o, d = tb.aimed_rays(a, n, seed=2)
        plain = make_tracer(scene, packet=512, sort="morton", device="cpu")
        planned = make_tracer(scene, packet=512, sort="morton", plan="key",
                              device="cpu")
        for x, y in zip(planned(o, d), plain(o, d)):
            assert same_bits(x, y)
        planner = trace_mod.make_key_planner(scene, packet=512, device="cpu")
        ot = torch.from_numpy(o)
        rows = rows_composed(ot, torch.from_numpy(d))
        assert torch.equal(planner(rows[10:13].t()), planner(ot))


def refused(fault: str, device="cpu"):
    """``(call, args)`` for one of the wrappers with one ``fault``."""
    o, d = order_case(300, 4, "random", device)
    perm = torch.randperm(300, generator=torch.Generator().manual_seed(0))
    perm = perm.to(device)
    if fault == "float64_origins":
        return ray_key, (o.double(), d, "morton", 6)
    if fault == "int_directions":
        return ray_rows, (o, d.int(), perm)
    if fault == "four_columns":
        return ray_key, (torch.cat([o, o[:, :1]], 1),
                         torch.cat([d, d[:, :1]], 1), "morton", 6)
    if fault == "flat_origins":
        return ray_rows, (o.reshape(-1), d.reshape(-1), None)
    if fault == "transposed_origins":
        return ray_key, (o.t().contiguous().t(), d, "octant", 2)
    if fault == "strided_directions":
        return ray_rows, (o, torch.cat([d, d], 1)[:, :3], perm)
    if fault == "shapes_differ":
        return ray_rows, (o, d[:-1], None)
    if fault == "unknown_mode":
        return ray_key, (o, d, "hilbert", 6)
    if fault == "perm_int32":
        return ray_rows, (o, d, perm.int())
    if fault == "perm_short":
        return ray_rows, (o, d, perm[:-1])
    if fault == "perm_strided":
        return ray_rows, (o, d, torch.stack([perm, perm], 1)[:, 0])
    assert fault in ("well_formed_key", "well_formed_rows")
    if fault == "well_formed_key":
        return ray_key, (o, d, "morton", 6)
    return ray_rows, (o, d, perm)


FAULTS = ["float64_origins", "int_directions", "four_columns", "flat_origins",
          "transposed_origins", "strided_directions", "shapes_differ",
          "unknown_mode", "perm_int32", "perm_short", "perm_strided"]


@pytest.mark.parametrize("fault", FAULTS + ["well_formed_key",
                                            "well_formed_rows"])
def test_the_kernel_wrappers_refuse_what_they_do_not_take(fault):
    """Every fault raises before any launch; a well-formed CPU call raises
    too (the CPU runs the plain composition, never these wrappers)."""
    call, args = refused(fault)
    before = launches()
    with pytest.raises(ValueError) as err:
        call(*args)
    assert ("no order kernel" in str(err.value)) == fault.startswith(
        "well_formed")
    assert launches() == before
