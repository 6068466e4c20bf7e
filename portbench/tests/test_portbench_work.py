"""CPU tests of the work model and of the trace reduction: the program's
kernels told from PyTorch's, and a synthetic Chrome trace whose device
operations go to the innermost stage that launched them and whose idle
gaps are named by stage."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from pytest import approx

from portbench import devtrace
from portbench import plugin
from portbench.harness import ROOT
from portbench.reference import hits
from portbench.work import bvh, model, walk


def two_triangles():
    """Two triangles facing -z, one across z = 5 and one across z = 10,
    each spanning x, y in [-1, 2]."""
    a = np.array([[-1, -1, 5], [-1, -1, 10]], np.float32)
    b = np.array([[-1, 2, 5], [-1, 2, 10]], np.float32)
    c = np.array([[2, -1, 5], [2, -1, 10]], np.float32)
    return a, b, c


def _tensors(tree):
    return {k: (torch.as_tensor(v) if k != "depth" else v)
            for k, v in tree._asdict().items()}


def test_the_two_triangle_tree():
    t = bvh.build(*two_triangles())
    assert t.depth == 2 and list(t.left) == [1, -1, -1]
    assert list(t.right) == [2, -1, -1] and list(t.prim) == [-1, 0, 1]
    np.testing.assert_array_equal(t.lo[0], [-1, -1, 5])
    np.testing.assert_array_equal(t.hi[0], [2, 2, 10])


def test_the_walks_count_exactly_on_two_triangles():
    tris_np = two_triangles()
    tree = _tensors(bvh.build(*tris_np))
    tris = tuple(torch.from_numpy(x) for x in tris_np)
    o = torch.tensor([[0.0, 0.0, 0.0],    # hits both; the far one is pruned
                      [0.0, 0.0, 7.0],    # starts between them: one test
                      [0.0, 0.0, 20.0],   # looks away from both boxes
                      [0.0, 0.0, 0.0]])   # misses the root box sideways
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0],
                      [1.0, 0.0, 0.0]])
    box, prim, best = walk.ray_walk(tree, tris, o, d)
    assert box.tolist() == [3, 3, 1, 1]
    assert prim.tolist() == [1, 1, 0, 0]
    assert best.tolist()[:2] == [5.0, 3.0]
    p = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 7.0]])
    box, prim, best = walk.point_walk(tree, tris, p)
    # at z = 7 the nearer triangle (z = 5, d^2 = 4) prunes the other's box
    # (d^2 = 9); at z = 0 the box at z = 10 (d^2 = 100) is pruned by 25
    assert box.tolist() == [3, 3] and prim.tolist() == [1, 1]
    assert best.tolist() == [25.0, 4.0]
    c = {"box": 3.0, "prim": 1.0}
    bnd = model.bound(c, 1000, 2, points=False)
    assert bnd["ops"] == 1000 * (3 * 25 + 44)
    assert bnd["bytes"] == 1000 * 40 + 2 * 36
    assert bnd["bound_ms"] == max(bnd["ops"] / 67e12,
                                  bnd["bytes"] / 3.35e12) * 1e3


def test_the_walk_finds_brute_force_hits_on_cubes():
    tris_np = plugin(ROOT, "scenes", "create_n_cubes").make(60)
    tree = _tensors(bvh.build(*tris_np))
    tris = tuple(torch.from_numpy(x) for x in tris_np)
    g = torch.Generator().manual_seed(3)
    centers = tris[0].reshape(-1, 12, 3).mean(1)
    off = torch.randn(300, 3, generator=g)
    o = centers[torch.arange(300) % 60] + 50 * off / off.norm(dim=1,
                                                              keepdim=True)
    d = centers[torch.arange(300) % 60] + 0.1 - o
    box, prim, best = walk.ray_walk(tree, tris, o, d)
    t_ref, _ = hits.closest_hits(o, d, tris)
    assert torch.equal(torch.isfinite(best), torch.isfinite(t_ref))
    assert float(((best.double() - t_ref) / t_ref).abs().max()) < 1e-6
    assert (prim >= 1).all() and (box >= 3).all()


def test_the_tree_and_counts_are_cached(tmp_path):
    tris_np = plugin(ROOT, "scenes", "create_n_cubes").make(20)
    t1 = model.tree(tris_np, tmp_path)
    t2 = model.tree(tris_np, tmp_path)
    assert all(np.array_equal(t1[k], t2[k]) for k in t1)
    tris = tuple(torch.from_numpy(x) for x in tris_np)
    p = (torch.rand(64, 3, generator=torch.Generator().manual_seed(1))
         * 2e5 - 1e5,)
    c1 = model.counts(t1, tris, p, True, tmp_path, ("cell", 1, 64))
    c2 = model.counts(t1, tris, p, True, tmp_path, ("cell", 1, 64))
    assert c1 == c2 and c1["units"] == 64 and c1["prim"] >= 1


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_the_trace_reduction_tells_the_programs_kernels_from_pytorchs():
    host = [
        _ev("user_annotation", "portbench.batch", 0, 100),
        _ev("user_annotation", "portbench.call", 0, 60),
        _ev("cpu_op", "aten::sort", 6, 9),
        _ev("cuda_runtime", "cudaLaunchKernel", 8, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=2),
        _ev("cpu_op", "aten::copy_", 30, 5),
        _ev("cuda_runtime", "cudaMemcpyAsync", 31, 1, correlation=3),
        _ev("user_annotation", "portbench.sync", 60, 40),
    ]
    device = [
        _ev("kernel", "void at::native::sortKernel", 10, 10, tid=7,
            correlation=1),
        _ev("kernel", "renamed_walk_kernel", 22, 30, tid=7, correlation=2),
        _ev("gpu_memcpy", "Memcpy DtoD", 70, 10, tid=7, correlation=3),
    ]
    labels = devtrace.classify(host + device)
    assert labels["mine"] == {"void at::native::sortKernel": False,
                              "renamed_walk_kernel": True}
    # idle 0-10 and 20-22 inside the call, 52-70 and 80-100 in the sync
    assert dict(labels["idle_gaps"]) == {"portbench.call": approx(12e-6),
                                         "portbench.sync": approx(38e-6)}
    red = devtrace.reduce_device(device, labels, 100e-6, 1)
    assert red["port_ms"] == approx(30e-3) and red["torch_ms"] == approx(20e-3)
    assert red["busy_s"] == approx(50e-6) and red["window_s"] == 100e-6
    assert red["device_ops"][0] == ["renamed_walk_kernel", approx(30e-6)]
    # a kernel whose launch the trace lost makes the trace unusable, and so
    # does a kernel the labelling stretch never saw
    assert devtrace.classify(host[:4] + host[5:] + device) is None
    other = [_ev("kernel", "new_kernel", 0, 1, tid=7)]
    assert devtrace.reduce_device(device + other, labels, 1e-4, 1) is None


def synthetic_trace(top: str = "trace"):
    """One batch: the call around the program's ``top`` span and its four
    stages; four operations, one of them launched before ``top``."""
    ann = "user_annotation"
    return [
        _ev(ann, "portbench.batch", 0, 100),
        _ev(ann, "portbench.call", 0, 90),
        _ev(ann, f"bvh.{top}", 5, 80),
        _ev(ann, f"bvh.{top}/sort", 10, 10),
        _ev(ann, f"bvh.{top}/prologue", 22, 6),
        _ev(ann, f"bvh.{top}/walk", 30, 30),
        _ev(ann, f"bvh.{top}/epilogue", 65, 15),
        _ev("cpu_op", "aten::mul", 11, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 35, 1, correlation=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 70, 1, correlation=3),
        _ev("kernel", "outside_kernel", 4, 2, tid=7, correlation=4),
        _ev("kernel", "sort_kernel", 14, 10, tid=7, correlation=1),
        _ev("kernel", "walk_kernel", 36, 20, tid=7, correlation=2),
        _ev("gpu_memcpy", "Memcpy DtoD", 72, 2, tid=7, correlation=3),
    ]


def test_operations_go_to_the_innermost_stage_that_launched_them():
    got = devtrace.classify_stages(synthetic_trace())
    st = got["stages"]
    assert got["batches"] == 1
    assert st["trace/sort"] == {"device_ms": 0.010, "launches": 1,
                                "idle_ms": pytest.approx(0.008)}
    assert st["trace/prologue"] == {"device_ms": 0.0, "launches": 0,
                                    "idle_ms": 0.0}
    assert st["trace/walk"] == {"device_ms": 0.020, "launches": 1,
                                "idle_ms": pytest.approx(0.012)}
    assert st["trace/epilogue"] == {"device_ms": 0.002, "launches": 1,
                                    "idle_ms": 0.0}
    # the top counts what its stages do, and the gap between them
    assert st["trace"]["device_ms"] == pytest.approx(0.032)
    assert st["trace"]["launches"] == 3
    assert st["trace"]["idle_ms"] == pytest.approx(0.036)
    # classify hands the stages on beside the kernels' owners
    assert devtrace.classify(synthetic_trace())["stages"] == st


def test_gaps_are_named_by_stage_and_the_rest_by_the_call():
    gaps = dict(devtrace.classify_stages(synthetic_trace())["idle_gaps"])
    # [0, 4] and [74, 100]: in the call, outside the program's spans
    assert gaps["portbench.call"] == pytest.approx(30e-6)
    assert gaps["bvh.trace/sort"] == pytest.approx(8e-6)  # [6, 14]
    assert gaps["bvh.trace/walk"] == pytest.approx(12e-6)  # [24, 36]
    assert gaps["bvh.trace"] == pytest.approx(16e-6)  # [56, 72]
    assert set(gaps) == {"portbench.call", "bvh.trace/sort",
                         "bvh.trace/walk", "bvh.trace"}


def test_a_trace_that_lost_a_kernel_or_holds_no_batch_reads_nothing():
    events = synthetic_trace()
    assert devtrace.classify_stages([e for e in events
                                     if e["name"] != "walk_kernel"]) is None
    assert devtrace.classify_stages([e for e in events
                                     if e["name"] != "portbench.batch"]) is None
