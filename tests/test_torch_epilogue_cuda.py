"""The closest-hit trace's epilogue kernel (``csrc/epilogue.cu``,
``ops/epilogue.py``) on the card against the composition it replaced
(``test_torch_epilogue.py::composed``) on the same tensors, bit for bit: with
and without the triangle tables, bound and un-sort, at n = 1, 257 and
1,048,576, on the cases' misses, culled and back-facing winners and lane ids
at both clamps; whole ``make_tracer`` calls and a path-traced frame with the
plain composition patched in; one launch a closest-hit call; the plain
composition where the recompute carries a gradient; the wrapper's refusals.
Needs an NVIDIA GPU and skips elsewhere; the file imports no JAX:

    python -m pytest tests/test_torch_epilogue_cuda.py -q --noconftest
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from bvh_tpu_torch import Ray, obs
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import build_tight_scene, make_tracer
from bvh_tpu_torch.ops import trace as trace_mod
from bvh_tpu_torch.ops import trace_closest_hit_tight
from bvh_tpu_torch.ops.epilogue import closest_epilogue
from test_torch_epilogue import (FAULTS, assert_same_bits, composed,
                                 epilogue_case, refused)

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def launches() -> int:
    return obs.counted("launch.trace_epilogue")


def plain_epilogue(scene, rays_s, rows, tris, t, lane_id, tm, bounded,
                   inv=None, tris9=None):
    """``ops/trace.py::_epilogue`` with the plain composition on any
    device."""
    with obs.span("epilogue"):
        return composed(scene, rays_s, rows, tris, t, lane_id, tm, bounded,
                        inv)


@pytest.mark.parametrize("n", [1, 257, 1 << 20])
@pytest.mark.parametrize("unsort", [False, True])
@pytest.mark.parametrize("bound", [None, "scalar", "per_ray"])
@pytest.mark.parametrize("tables", [None, "separate", "views9", "table9"])
def test_kernel_equals_the_composition(cuda, n, unsort, bound, tables):
    """``tables``: none (u = v = 0), three [n_tris, 3] tensors, views of
    one [n_tris, 9] table (the path tracer's), or the views with the table
    beside them (``make_tracer``'s)."""
    scene, rays, rows, tris, *rest = epilogue_case(n, 70 + n, bound, unsort,
                                                   cuda)
    if tables is None:
        tris = None
    elif tables in ("views9", "table9"):
        tris9 = torch.cat(tris, dim=1)
        tris = tris9.split(3, dim=1)
    before = launches()
    got = trace_mod._epilogue(scene, rays, rows, tris, *rest,
                              tris9=tris9 if tables == "table9" else None)
    assert launches() == before + 1
    want = composed(scene, rays, rows, tris, *rest)
    torch.cuda.synchronize()
    assert_same_bits(got, want)


@pytest.fixture(scope="module")
def cubes(cuda):
    a, b, c = tb.create_n_cubes(2000)
    o1, d1 = tb.aimed_rays(a, 40_000, seed=5)
    o2, d2 = tb.create_rays(9_000, seed=tb.seed_state_after(2000))
    return (build_tight_scene(a, b, c), (a, b, c),
            np.concatenate([o1, o2]), np.concatenate([d1, d2]))


@pytest.mark.parametrize("sort", ["morton", None])
@pytest.mark.parametrize("exact", [True, False])
def test_tracer_with_the_kernel_equals_the_plain_epilogue(cubes, cuda,
                                                          monkeypatch, sort,
                                                          exact):
    scene, tris, o, d = cubes
    tracer = make_tracer(scene, packet=1024, sort=sort,
                         tris=tris if exact else None, device=cuda)
    before = launches()
    got = tracer(o, d)
    assert launches() == before + 1
    monkeypatch.setattr(trace_mod, "_epilogue", plain_epilogue)
    want = tracer(o, d)
    assert launches() == before + 1
    torch.cuda.synchronize()
    assert torch.isfinite(want.t).sum() > 30_000
    assert_same_bits(got, want)


@pytest.mark.parametrize("t_max", ["scalar", "per_ray"])
def test_bounded_trace_with_the_kernel_equals_the_plain_epilogue(
        cubes, cuda, monkeypatch, t_max):
    scene, tris, o, d = cubes
    rays = Ray.create(o, d, device="cpu")
    rays = Ray(*(x.to(cuda) for x in rays))
    tris_d = tuple(torch.from_numpy(x).to(cuda) for x in tris)
    # bounds about the rays' own hits, so that some hits fall beyond them
    free = trace_closest_hit_tight(scene, rays, tris=tris_d, device=cuda).t
    if t_max == "scalar":
        tm = float(free[torch.isfinite(free)].median())
    else:
        scale = torch.rand(len(o), generator=torch.Generator().manual_seed(1))
        tm = torch.where(torch.isfinite(free), free, 1e6) * (
            0.5 + scale.to(cuda))
    before = launches()
    got = trace_closest_hit_tight(scene, rays, tris=tris_d, t_max=tm,
                                  sweep=True, device=cuda)
    assert launches() == before + 1
    monkeypatch.setattr(trace_mod, "_epilogue", plain_epilogue)
    want = trace_closest_hit_tight(scene, rays, tris=tris_d, t_max=tm,
                                   sweep=True, device=cuda)
    torch.cuda.synchronize()
    assert torch.isfinite(want.t).any() and not torch.isfinite(want.t).all()
    assert_same_bits(got, want)


def test_column_major_tables_on_the_card_trace_as_row_major_ones(cubes,
                                                                 cuda):
    """(a, b, c) in column-major order, numpy's and a transposed tensor's:
    the kernel takes them (``_tris_on`` copies them to a unit column
    stride) and gives the bits of the row-major tables."""
    scene, tris, o, d = cubes
    rays = Ray.create(o, d, device="cpu")
    rays = Ray(*(x.to(cuda) for x in rays))
    want = trace_closest_hit_tight(scene, rays, tris=tris, device=cuda)
    for fortran in (tuple(np.asfortranarray(x) for x in tris),
                    tuple(torch.from_numpy(x).to(cuda).t().contiguous().t()
                          for x in tris)):
        assert all(torch.as_tensor(x).stride(1) != 1 for x in fortran)
        before = launches()
        got = trace_closest_hit_tight(scene, rays, tris=fortran, device=cuda)
        assert launches() == before + 1
        torch.cuda.synchronize()
        assert_same_bits(got, want)


def test_a_frame_with_the_kernel_equals_the_plain_epilogue(cuda,
                                                           monkeypatch):
    from portbench import plugin
    from bvh_tpu_torch.render import make_pathtracer

    entry = plugin(ROOT, "entries", "pathtracer")
    tris_np = plugin(ROOT, "scenes", "spd_tetra").make(5)
    trace = make_pathtracer(build_tight_scene(*tris_np), tris_np, bounces=2,
                            packet=1024, device=cuda, **entry.SHADING)
    g = torch.Generator(device=cuda).manual_seed(2**31 + 7)
    o, d, noise = plugin(ROOT, "kinds", "camera").make(
        64 * 64, g, {"scene": "spd_tetra", "tile": 32, "bounces": 2},
        {"device": cuda, "tris": None})
    before = launches()
    got = trace(o, d, noise=noise, waves=True)
    assert launches() == before + 3  # the closest-hit waves
    monkeypatch.setattr(trace_mod, "_epilogue", plain_epilogue)
    want = trace(o, d, noise=noise, waves=True)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                           y.view(torch.int32) if y.is_floating_point() else y)


def test_a_recompute_that_carries_a_gradient_runs_the_plain_epilogue(cuda):
    # no un-sort: the plain one moves bit patterns, which carry no gradient
    scene, rays, rows, tris, *rest = epilogue_case(2000, 11, "per_ray", False,
                                                   cuda)
    want = composed(scene, rays, rows, tris, *rest)
    leaves = tuple(x.clone().requires_grad_(True) for x in tris)
    before = launches()
    got = trace_mod._epilogue(scene, rays, rows, leaves, *rest)
    assert launches() == before
    assert_same_bits(tuple(x.detach() for x in got), want)
    (got.t[torch.isfinite(got.t)].sum() + got.u.sum()).backward()
    assert all(x.grad is not None and bool((x.grad != 0).any())
               for x in leaves)
    with torch.no_grad():
        got = trace_mod._epilogue(scene, rays, rows, leaves, *rest)
    assert launches() == before + 1
    assert_same_bits(got, want)


@pytest.mark.parametrize("fault", FAULTS)
def test_the_kernel_wrapper_refuses_on_the_card(cuda, fault):
    args, kw = refused(fault, cuda)
    before = launches()
    with pytest.raises(ValueError):
        closest_epilogue(*args, **kw)
    assert launches() == before


def test_the_epilogue_refuses_float64_tables_on_the_card(cuda):
    scene, rays, rows, tris, *rest = epilogue_case(300, 3, None, False, cuda)
    with pytest.raises(ValueError, match="float32"):
        trace_mod._epilogue(scene, rays, rows,
                            tuple(x.double() for x in tris), *rest)
