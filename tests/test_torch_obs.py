"""The port's tracing (``bvh_tpu_torch/obs.py``), on the CPU: spans off are
one shared no-op; the self and total arithmetic of nested spans under an
injected clock; a raising span leaves the stack balanced; counters, launch
counts and reset; the four stages of ``make_tracer``'s call,
``trace_closest_hit_tight``, ``trace_any_hit_tight`` and
``nearest_tight`` under their top span, once a call; outputs bit-equal with
spans on and off; ``bvh.*`` ranges nested on ``torch.profiler``'s
timeline; ``_dev``'s uploads counted once a table; counters from many
threads.

Run: ``python -m pytest tests/test_torch_obs.py -q``.
"""

from __future__ import annotations

import json
import sys
import threading

import numpy as np
import pytest
import torch

from bvh_tpu_torch import Ray, obs
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import (build_chained_scene, build_tight_scene,
                               make_tracer, nearest_tight,
                               trace_any_hit_tight, trace_closest_hit_chained,
                               trace_closest_hit_tight)
from bvh_tpu_torch.ops.sweep import node_records
from bvh_tpu_torch.ops.trace import _dev, sort_rays_device

CPU = torch.device("cpu")
STAGES = ("sort", "prologue", "walk", "epilogue")
N_RAYS = 300  # above 128, so that nearest_tight sorts


@pytest.fixture(autouse=True)
def clean_registry():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@pytest.fixture(scope="module")
def world():
    a, b, c = tb.create_n_cubes(40)
    scene = build_tight_scene(a, b, c)
    o, d = tb.aimed_rays(a, N_RAYS, seed=3)
    return (a, b, c), scene, o, d


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_bit_equal(x, y):
    for p, q in zip(x, y):
        assert torch.equal(_bits(p), _bits(q))


def _assert_stages(top: str, calls: int, children=STAGES):
    """``top`` and its stages entered once a call, each self time the total
    less its children's."""
    spans = obs.snapshot()["spans"]
    assert spans[top]["n"] == calls
    for s in children:
        assert spans[f"{top}/{s}"]["n"] == calls, s
    for path, rec in spans.items():
        kids = [r["total_s"] for p, r in spans.items()
                if p.rsplit("/", 1)[0] == path and "/" in p]
        assert rec["self_s"] == pytest.approx(rec["total_s"] - sum(kids),
                                              abs=1e-9)
        assert rec["self_s"] >= -1e-9 and rec["total_s"] >= 0.0


def test_off_is_one_shared_no_op(world):
    tris, scene, o, d = world
    assert obs.span("trace") is obs.span("walk")
    with obs.span("trace"):
        pass
    make_tracer(scene, device=CPU, tris=tris)(o, d)
    nearest_tight(scene, o, device=CPU)
    assert obs.snapshot()["spans"] == {}


def test_nested_spans_self_and_total_with_an_injected_clock(monkeypatch):
    ticks = iter([0.0, 1.0, 3.0, 3.5, 4.0, 6.0, 7.0, 7.25, 7.5, 9.0])
    monkeypatch.setattr(obs, "_clock", lambda: next(ticks))
    obs.enable()
    with obs.span("trace"):  # 0 .. 6
        with obs.span("sort"):  # 1 .. 3
            pass
        with obs.span("walk"):  # 3.5 .. 4
            pass
    with obs.span("trace"):  # 7 .. 9
        with obs.span("walk"):  # 7.25 .. 7.5
            pass
    spans = obs.snapshot()["spans"]
    assert spans["trace"] == {"n": 2, "total_s": 8.0, "self_s": 5.25}
    assert spans["trace/sort"] == {"n": 1, "total_s": 2.0, "self_s": 2.0}
    assert spans["trace/walk"] == {"n": 2, "total_s": 0.75, "self_s": 0.75}
    assert set(spans) == {"trace", "trace/sort", "trace/walk"}


def test_a_raising_span_leaves_the_stack_balanced():
    obs.enable()
    with pytest.raises(ValueError):
        with obs.span("trace"):
            with obs.span("walk"):
                raise ValueError("inside the walk")
    assert obs._stack() == []
    with obs.span("nearest"):
        pass
    spans = obs.snapshot()["spans"]
    assert spans["trace"]["n"] == spans["trace/walk"]["n"] == 1
    assert "nearest" in spans  # a root again, not under trace


def test_count_launch_and_reset():
    obs.count("table_upload")
    obs.count("table_upload_bytes", 96)
    obs.count("table_upload_bytes", 32)
    obs.launch("wide_trace", any=False, frame=True)
    obs.launch("wide_trace", any=True, frame=True)
    assert obs.counted("table_upload") == 1
    assert obs.counted("table_upload_bytes") == 128
    assert obs.counted("launch.wide_trace") == 2
    assert obs.counted("launch.wide_trace.frame") == 2
    assert obs.counted("launch.wide_trace.any") == 1
    assert obs.counted("launch.never") == 0
    assert obs.snapshot()["counts"]["launch.wide_trace"] == 2
    obs.enable()
    with obs.span("trace"):
        pass
    obs.reset()
    assert obs.snapshot() == {"spans": {}, "counts": {}}


@pytest.mark.parametrize("exact", [True, False], ids=["tris", "no_tris"])
@pytest.mark.parametrize("sort", ["morton", "octmorton", None])
def test_make_tracer_gives_four_stages_a_call(world, sort, exact):
    tris, scene, o, d = world
    tracer = make_tracer(scene, packet=128, sort=sort, device=CPU,
                         tris=tris if exact else None)
    tracer(o, d)  # the first call copies the exact-frame table
    obs.reset()
    with obs.tracing():
        for _ in range(3):
            tracer(o, d)
    _assert_stages("trace", 3)
    counts = obs.snapshot()["counts"]
    assert counts.get("table_upload", 0) == 0  # no table copied a call
    assert counts.get("launch.wide_trace", 0) == 0  # the plain version ran


@pytest.mark.parametrize("perm", [False, True], ids=["sorted", "perm"])
@pytest.mark.parametrize("entry", ["closest", "any"])
def test_tight_entries_give_four_stages_a_call(world, entry, perm):
    tris, scene, o, d = world
    rays = Ray.create(o, d, device=CPU)
    kw = {"device": CPU, "packet": 128, "sweep": True}
    if perm:
        kw["perm"] = sort_rays_device(o, d, device=CPU)[0]
    with obs.tracing():
        for _ in range(2):
            if entry == "closest":
                trace_closest_hit_tight(scene, rays, tris=tris, t_max=80.0,
                                        **kw)
            else:
                trace_any_hit_tight(scene, rays, t_max=80.0, **kw)
    _assert_stages("trace", 2)


@pytest.mark.parametrize("sort", [True, False], ids=["sort", "no_sort"])
@pytest.mark.parametrize("wide", [None, False], ids=["group", "entry_exit"])
def test_nearest_tight_gives_four_stages_a_call(world, wide, sort):
    _, scene, o, _ = world
    pts = o + np.float32(0.5)
    nearest_tight(scene, pts, wide=wide, sort=sort, device=CPU)
    obs.reset()
    with obs.tracing():
        for _ in range(2):
            nearest_tight(scene, pts, wide=wide, sort=sort, d_max=40.0,
                          device=CPU)
    _assert_stages("nearest", 2)
    assert obs.counted("table_upload") == 0


def test_chained_trace_is_one_span_with_a_walk_a_part(world):
    tris, _, o, d = world
    chained = build_chained_scene(*tris, max_part=160)
    parts = len(chained.parts)
    assert parts > 1
    with obs.tracing():
        trace_closest_hit_chained(chained, Ray.create(o, d, device=CPU),
                                  device=CPU)
    spans = obs.snapshot()["spans"]
    assert spans["trace_chained"]["n"] == 1
    assert spans["trace_chained/walk"]["n"] == parts
    for s in ("sort", "prologue", "epilogue"):
        assert spans[f"trace_chained/{s}"]["n"] == 1


def _entry_outputs(entry, world):
    tris, scene, o, d = world
    rays = Ray.create(o, d, device=CPU)
    if entry == "tracer":
        h = make_tracer(scene, packet=128, sort="morton", device=CPU,
                        tris=tris)(o, d)
        return tuple(h)
    if entry == "closest":
        return tuple(trace_closest_hit_tight(scene, rays, tris=tris,
                                             packet=128, device=CPU))
    if entry == "any":
        return (trace_any_hit_tight(scene, rays, t_max=60.0, packet=128,
                                    device=CPU),)
    return nearest_tight(scene, o, device=CPU)


@pytest.mark.parametrize("entry", ["tracer", "closest", "any", "nearest"])
def test_outputs_are_bit_equal_with_spans_on_and_off(world, entry):
    off = _entry_outputs(entry, world)
    with obs.tracing():
        on = _entry_outputs(entry, world)
    assert obs.snapshot()["spans"]
    _assert_bit_equal(off, on)


def _ranges(path) -> dict:
    """The ``bvh.*`` ranges of a Chrome trace: name -> [(start, end)]."""
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("name", "").startswith("bvh."):
            ts = float(e["ts"])
            out.setdefault(e["name"], []).append((ts, ts + float(e["dur"])))
    return out


@pytest.mark.parametrize("entry", ["tracer", "nearest"])
def test_profiler_timeline_holds_nested_bvh_ranges(world, entry, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    top = "trace" if entry == "tracer" else "nearest"
    with obs.tracing(), profile(activities=[ProfilerActivity.CPU]) as prof:
        _entry_outputs(entry, world)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    ranges = _ranges(tmp_path / "trace.json")
    (t0, t1), = ranges[f"bvh.{top}"]
    for s in STAGES:
        (s0, s1), = ranges[f"bvh.{top}/{s}"]
        assert t0 <= s0 <= s1 <= t1, s
    # spans off under the profiler: no range
    obs.disable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _entry_outputs(entry, world)
    prof.export_chrome_trace(str(tmp_path / "off.json"))
    assert _ranges(tmp_path / "off.json") == {}


@pytest.mark.parametrize("kind", ["numpy", "numpy_layout", "tensor_layout",
                                  "tensor_here"])
def test_dev_counts_one_upload_a_table_and_then_none(world, kind):
    _, scene, _, _ = world
    table = np.array(scene.smem_nodes)  # a table no call has copied yet
    arr = torch.from_numpy(table) if kind.startswith("tensor") else table
    layout = node_records if kind.endswith("layout") else None
    first = _dev(arr, CPU, layout)
    uploads = 0 if kind == "tensor_here" else 1
    assert obs.counted("table_upload") == uploads
    assert obs.counted("table_upload_bytes") == (
        uploads * first.numel() * first.element_size())
    again = _dev(arr, CPU, layout)
    assert again is first or kind == "tensor_here"
    assert obs.counted("table_upload") == uploads
    if kind == "tensor_layout":  # an in-place change makes the layout again
        arr.add_(0.0)
        _dev(arr, CPU, layout)
        assert obs.counted("table_upload") == 2


def test_counters_and_spans_from_many_threads():
    threads, adds = 16, 2000
    errors = []

    def work():
        try:
            for _ in range(adds):
                obs.count("x")
                with obs.span("t"):
                    obs.count("y", 2)
        except Exception as e:  # reported by the assert below
            errors.append(e)

    obs.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in pool) and not errors
    snap = obs.snapshot()
    assert snap["counts"] == {"x": threads * adds, "y": 2 * threads * adds}
    # each thread nests under its own spans only
    assert snap["spans"].keys() == {"t"}
    assert snap["spans"]["t"]["n"] == threads * adds
