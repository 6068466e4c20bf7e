"""CPU tests of the per-stage measurement (``portbench/stages.py``) and its
readers: a synthetic Chrome trace places each device operation in the
innermost stage that launched it and names each idle gap by stage; on
the CPU a traced run's new readers return nothing and raise nothing, and
the spans-on stretches give every stage of the entry a call.

Run: ``python -m pytest portbench/tests -q`` from the repository root.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from portbench import harness, stages, traffic
from portbench.tests.test_portbench_harness import ROOT, run_small, small_cell


def _x(name, ts, dur, cat, tid=1, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "tid": tid, "args": args}


def synthetic_trace():
    """One batch: the call around the program's ``trace`` and three of its
    stages; four operations, one of them launched before ``trace``."""
    ann = "user_annotation"
    return [
        _x("portbench.batch", 0, 100, ann),
        _x("portbench.call", 0, 90, ann),
        _x("bvh.trace", 5, 80, ann),
        _x("bvh.trace/sort", 10, 10, ann),
        _x("bvh.trace/walk", 30, 30, ann),
        _x("bvh.trace/epilogue", 65, 15, ann),
        _x("aten::mul", 11, 2, "cpu_op"),
        _x("cudaLaunchKernel", 3, 1, "cuda_runtime", correlation=4),
        _x("cudaLaunchKernel", 12, 1, "cuda_runtime", correlation=1),
        _x("cudaLaunchKernel", 35, 1, "cuda_runtime", correlation=2),
        _x("cudaMemcpyAsync", 70, 1, "cuda_runtime", correlation=3),
        _x("outside_kernel", 4, 2, "kernel", tid=7, correlation=4),
        _x("sort_kernel", 14, 10, "kernel", tid=7, correlation=1),
        _x("walk_kernel", 36, 20, "kernel", tid=7, correlation=2),
        _x("Memcpy DtoD", 72, 2, "gpu_memcpy", tid=7, correlation=3),
    ]


def test_operations_go_to_the_innermost_stage_that_launched_them():
    got = stages.classify_stages(synthetic_trace())
    st = got["stages"]
    assert got["batches"] == 1
    assert st["trace/sort"] == {"device_ms": 0.010, "launches": 1,
                                "idle_ms": pytest.approx(0.008)}
    assert st["trace/walk"] == {"device_ms": 0.020, "launches": 1,
                                "idle_ms": pytest.approx(0.012)}
    assert st["trace/epilogue"] == {"device_ms": 0.002, "launches": 1,
                                    "idle_ms": 0.0}
    # the top counts what its stages do, and the gap between them
    assert st["trace"]["device_ms"] == pytest.approx(0.032)
    assert st["trace"]["launches"] == 3
    assert st["trace"]["idle_ms"] == pytest.approx(0.036)


def test_gaps_are_named_by_stage_and_the_rest_by_the_call():
    gaps = dict(stages.classify_stages(synthetic_trace())["idle_gaps"])
    # [0, 4] and [74, 100]: in the call, outside the program's spans
    assert gaps["portbench.call"] == pytest.approx(30e-6)
    assert gaps["bvh.trace/sort"] == pytest.approx(8e-6)  # [6, 14]
    assert gaps["bvh.trace/walk"] == pytest.approx(12e-6)  # [24, 36]
    assert gaps["bvh.trace"] == pytest.approx(16e-6)  # [56, 72]
    assert set(gaps) == {"portbench.call", "bvh.trace/sort",
                         "bvh.trace/walk", "bvh.trace"}


def test_a_trace_that_lost_a_kernel_or_holds_no_batch_reads_nothing():
    events = synthetic_trace()
    assert stages.classify_stages([e for e in events
                                   if e["name"] != "walk_kernel"]) is None
    assert stages.classify_stages([e for e in events
                                   if e["name"] != "portbench.batch"]) is None


READERS = [n for top in ("trace", "nearest") for n in stages.metric_names(top)]


@pytest.fixture(scope="module")
def traced_on_cpu():
    return run_small(small_cell("cubes120k.aimed"), trace=True)


@pytest.mark.parametrize("name", READERS)
def test_new_readers_read_nothing_from_the_harness_traced_run(
        traced_on_cpu, name):
    """The harness's traced run on the CPU holds no device trace, and its
    readers' context neither spans nor stages: each new reader returns
    None and does not raise."""
    assert traced_on_cpu["correct"] and not traced_on_cpu["metrics"]
    ctx = SimpleNamespace(trace=None, bound=None, window={"calls": []})
    assert harness.reader(ROOT, name)(ctx) is None


def test_spans_on_stretches_give_each_stage_a_call_on_the_cpu():
    cell = small_cell("cubes120k.nearest")
    tris_np, tris, scene, call = harness.build(cell, "cpu")
    pool, _ = traffic.make_pool(cell.traffic, tris, 5, "cpu",
                                cell.entry.INPUTS, ROOT)
    for batch in pool:
        call(batch)
    m = stages.measure(call, pool, 0.05, torch.device("cpu"), pairs=2)
    assert m["outputs_bit_equal"] and m["stages"] is None
    assert m["counts"].get("table_upload", 0) == 0
    for s in ("nearest",) + tuple(f"nearest/{x}" for x in stages.STAGES):
        assert m["spans"][s]["n"] == 1.0, s
    rep = stages.report(m)
    assert rep["top"] == "nearest"
    # host numbers only: no device trace off the card
    assert set(rep["metrics"]) == {f"span_host_ms.nearest.{s}"
                                   for s in stages.STAGES}
    assert 0.5 < rep["sums"]["host_top_over_call"] <= 1.0
