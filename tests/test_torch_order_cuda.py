"""The tracer's coherence order and ray rows in hand-written kernels
(``csrc/order.cu``, ``ops/order.py``) on the card against the composition
they replaced (``test_torch_order.py``'s ``key_composed``,
``order_composed`` and the plain prologue) on the same tensors, bit for bit:
the key, ``perm`` and ``inv`` of every mode at n = 1, 127, 4,097 and
1,048,576, on uniform and aimed rays, equal origins, a flat axis and signed
zero directions; the rows; whole ``make_tracer`` calls against the plain
route; one launch of each kernel a sorted call, rays that carry a
gradient included, and the plain route's gradient; the wrappers'
refusals; and the order of the card's ``torch.sum`` over three and its
``torch.sqrt``, which the rows kernel repeats. Needs an NVIDIA GPU and
skips elsewhere; the file imports no JAX:

    python -m pytest tests/test_torch_order_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from bvh_tpu_torch import Ray, obs
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import build_tight_scene, make_tracer, sort_rays_device
from bvh_tpu_torch.ops import trace as trace_mod
from bvh_tpu_torch.ops.order import ray_key, ray_rows
from test_torch_order import (CASES, FAULTS, KEYS, key_composed, launches,
                              order_case, order_composed, refused, same_bits)

pytestmark = pytest.mark.cuda

SIZES = [1, 127, 4097, 1 << 20]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def plain_rows(o, d, perm):
    """The rows as ``make_tracer``'s plain route makes them: ``_take``, then
    ``Ray.create`` and ``_prologue``."""
    if perm is not None:
        o, d = trace_mod._take(perm, o, d)
    return trace_mod._prologue(Ray.create(o, d, device=o.device), None)[1]


@pytest.mark.parametrize("n", [1, 127, 4097, 1 << 20, 3 << 20])
@pytest.mark.parametrize("strided", [False, True])
def test_the_cards_sum_of_three_and_root(cuda, n, strided):
    """What the rows kernel repeats of ``Ray.create``: the card's
    ``torch.sum`` over the last axis of three squares adds x and z first,
    then y; its float32 ``torch.sqrt`` of those sums is the correctly
    rounded root (float64's, rounded once). ``strided``: the directions as
    ``_take`` gives them, a view of a [n, 6] gather."""
    g = torch.Generator(device=cuda).manual_seed(n)
    d = torch.randn(n, 6 if strided else 3, generator=g, device=cuda)
    d = d * torch.exp2(torch.randint(-20, 20, (n, 1), generator=g,
                                     device=cuda).float())
    d = d[:, :3]
    sq = d * d
    s = torch.sum(sq, dim=-1, keepdim=True)
    assert same_bits(s[:, 0], (sq[:, 0] + sq[:, 2]) + sq[:, 1])
    assert same_bits(torch.sqrt(s), torch.sqrt(s.double()).float())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode,bits", KEYS)
@pytest.mark.parametrize("case", CASES)
def test_key_and_order_equal_the_composition(cuda, n, mode, bits, case):
    o, d = order_case(n, 11 + n, case, cuda)
    before = launches()
    key = ray_key(o, d, mode, bits)
    perm, inv = sort_rays_device(o, d, bits=bits, mode=mode, device=cuda)
    assert launches() == (before[0] + 2, before[1])
    want_perm, want_inv = order_composed(o, d, bits, mode)
    torch.cuda.synchronize()
    assert same_bits(key, key_composed(o, d, bits, mode))
    assert same_bits(perm, want_perm) and same_bits(inv, want_inv)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("sorted_", [True, False])
def test_rows_equal_the_composition(cuda, n, case, sorted_):
    o, d = order_case(n, 5 + n, case, cuda)
    perm, want_inv = (order_composed(o, d, 6, "morton") if sorted_
                      else (None, None))
    before = launches()
    rows, inv = ray_rows(o, d, perm)
    assert launches() == (before[0], before[1] + 1)
    torch.cuda.synchronize()
    taken = (o, d) if perm is None else (o[perm], d[perm])
    want = trace_mod._prologue(Ray.create(*taken, device=cuda), None)[1]
    assert same_bits(rows, want)
    assert same_bits(rows, plain_rows(o, d, perm))
    assert (inv is None) == (perm is None)
    if perm is not None:
        assert same_bits(inv, want_inv)


@pytest.fixture(scope="module")
def cubes(cuda):
    a, b, c = tb.create_n_cubes(2000)
    o1, d1 = tb.aimed_rays(a, 40_000, seed=5)
    o2, d2 = tb.create_rays(9_000, seed=tb.seed_state_after(2000))
    return (build_tight_scene(a, b, c), (a, b, c),
            np.concatenate([o1, o2]), np.concatenate([d1, d2]))


@pytest.mark.parametrize("sort", ["morton", "octmorton", "octant", None])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("plan", [None, "key"])
def test_tracer_with_the_kernels_equals_the_plain_route(cubes, cuda,
                                                        monkeypatch, sort,
                                                        exact, plan):
    """A whole call with the kernels against the same call with the plain
    route patched in (``_on_card`` false: the plain order, rows and
    epilogue, no kernel of theirs launched); one launch of the key and one
    of the rows a call."""
    scene, tris, o, d = cubes
    tracer = make_tracer(scene, packet=1024, sort=sort, bits=2,
                         tris=tris if exact else None, plan=plan, device=cuda)
    before = launches()
    bounds = obs.counted("launch.ray_bounds")
    unsort = obs.counted("launch.ray_unsort")
    got = tracer(o, d)
    assert launches() == (before[0] + (sort is not None), before[1] + 1)
    assert obs.counted("launch.ray_bounds") == bounds + (sort is not None)
    assert obs.counted("launch.ray_unsort") == unsort + (sort is not None)
    monkeypatch.setattr(trace_mod, "_on_card", lambda x: False)
    epilogues = obs.counted("launch.trace_epilogue")
    want = tracer(o, d)
    assert launches() == (before[0] + (sort is not None), before[1] + 1)
    assert obs.counted("launch.trace_epilogue") == epilogues
    torch.cuda.synchronize()
    assert torch.isfinite(want.t).sum() > 30_000
    for x, y in zip(got, want):
        assert same_bits(x, y)


@pytest.mark.parametrize("sort", ["morton", None])
@pytest.mark.parametrize("exact", [True, False])
def test_rays_that_carry_a_gradient_take_the_order_kernels(cubes, cuda,
                                                           monkeypatch, sort,
                                                           exact):
    """Rays that require grad take the key and rows kernels all the same
    (an integer key and the walk's rows carry no gradient), with hits equal
    bit for bit to a call without grad. Only an unsorted call with ``tris``
    carries a gradient (a sorted call's un-sort moves bit patterns): its
    recompute reads the rays in the plain epilogue, and its gradient by the
    origins is the plain route's: equal in value, and bit for bit wherever
    it is not zero (the plain rows add a zero gradient through o·inv, which
    can turn a -0.0 into +0.0). Every other call takes the epilogue kernel
    too."""
    scene, tris, o, d = cubes
    tracer = make_tracer(scene, packet=1024, sort=sort,
                         tris=tris if exact else None, device=cuda)
    with torch.no_grad():
        want = tracer(o, d)
    grad = sort is None and exact

    def call():
        od = torch.from_numpy(o).to(cuda).requires_grad_(True)
        out = tracer(od, d)
        if not grad:
            return out, None
        loss = torch.where(torch.isfinite(out.t), out.t + out.u + out.v,
                           0.0).sum()
        return out, torch.autograd.grad(loss, od)[0]

    before = launches()
    epilogues = obs.counted("launch.trace_epilogue")
    got, g = call()
    assert launches() == (before[0] + (sort is not None), before[1] + 1)
    assert obs.counted("launch.trace_epilogue") == epilogues + (not grad)
    assert got.t.requires_grad == grad
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert same_bits(x.detach(), y)
    if grad:
        monkeypatch.setattr(trace_mod, "_on_card", lambda x: False)
        plain, g_plain = call()
        for x, y in zip(plain, want):
            assert same_bits(x.detach(), y)
        assert torch.isfinite(g).all() and (g != 0).any()
        assert torch.equal(g, g_plain)


@pytest.mark.parametrize("fault", FAULTS + ["perm_on_the_cpu",
                                            "directions_on_the_cpu"])
def test_the_kernel_wrappers_refuse_on_the_card(cuda, fault):
    if fault in ("perm_on_the_cpu", "directions_on_the_cpu"):
        call, (o, d, perm) = refused("well_formed_rows", cuda)
        args = ((o, d, perm.cpu()) if fault == "perm_on_the_cpu"
                else (o, d.cpu(), perm))
    else:
        call, args = refused(fault, cuda)
    before = launches()
    with pytest.raises(ValueError):
        call(*args)
    assert launches() == before
