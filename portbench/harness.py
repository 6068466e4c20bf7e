"""One run of one cell: find the cell's files by name, build the scene with
the program, make the pool of batches, warm up, run the closed loop (or the
traced stretches), check a sample of the answers against the reference, and
assemble the result line.

The loop has one caller: a batch is called, then the device is
synchronised, then the next batch is called, as a frame loop or a physics
step uses the library. Nothing here imports the program at module level.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType, SimpleNamespace

import numpy as np
import torch

from . import check, devtrace, plugin, traffic
from .work import model

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bvh_tpu")
TRACE_SECONDS = 1.0  # the traced stretch, at most
EVENT_PAIRS = 8192  # batches of a window whose device span is recorded
SPAN_PAIRS = 4  # spans-off and spans-on stretches, in turns


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path
    entry: ModuleType  # entries/<kind>.py of the mix's entry


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic mix, limits, entry and the metrics it reports."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells: {sorted(cells)}")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if (name in m["workloads"] if "workloads" in m
                  else m["moves"] in reported)]
    pkg = root / "portbench"
    mix = _json(pkg / "traffic" / f"{w['traffic']}.json")
    return Cell(name, int(w["chips"]), _json(root / conf["file"]), mix,
                _json(pkg / "cells" / f"{name}.json")["limits"], e2e, layers,
                root, plugin(root, "entries", mix["entry"]["kind"]))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _host_cpu():
    """The host CPU this thread last ran on (Linux), or None."""
    try:
        with open("/proc/thread-self/stat") as f:
            return int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, IndexError, ValueError):
        return None


def _window(call, pool, seconds: float, device) -> dict:
    """The closed loop for ``seconds`` and at least one pass over the pool:
    ``times``, each batch's seconds from the call to the synchronise's
    return; ``calls``, the seconds of each call alone (the host launching
    the batch); ``spans``, device ms of the first ``EVENT_PAIRS`` batches
    from the call's start to the end of its last device operation (CUDA
    events; empty off the card); ``kept``, the last answers of each pool
    slot; ``seconds``, the window's."""
    events = []
    if device.type == "cuda":
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(EVENT_PAIRS)]
    times, calls, kept, n = [], [], {}, 0
    gc.collect()
    w0 = time.perf_counter()
    while True:
        slot = n % len(pool)
        ev = events[n] if n < len(events) else None
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        out = call(pool[slot])
        if ev:
            ev[1].record()
        tc = time.perf_counter()
        _sync(device)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        calls.append(tc - t0)
        kept[slot] = out
        n += 1
        if n >= len(pool) and t1 - w0 >= seconds:
            spans = [a.elapsed_time(b) for a, b in events[:n]]
            return {"times": times, "calls": calls, "spans": spans,
                    "kept": kept, "seconds": t1 - w0}


def reader(root: Path, name: str):
    """The ``read`` of the per-layer metric ``name``: ``layers/<name>.py``,
    else the reader of its family: ``layers/<part before the first
    dot>.py`` (``kernel_ms.trace``: ``kernel_ms``), or ``layers/roofline.py``
    for a ``<kernels>_roofline``."""
    layers = Path(root) / "portbench" / "layers"
    for stem in (name, name.split(".")[0],
                 "roofline" if name.endswith("_roofline") else None):
        if stem and (layers / f"{stem}.py").is_file():
            return plugin(root, "layers", stem).read
    raise FileNotFoundError(f"portbench: no reader for {name!r} in {layers}")


def _finite(x):
    return x if isinstance(x, float) and math.isfinite(x) else None


def build(cell: Cell, device):
    """The configuration's triangles (numpy, and on ``device``), the
    program's scene over them, and the timed call."""
    from bvh_tpu_torch.ops.cluster import build_tight_scene

    conf = cell.config
    maker = plugin(cell.root, "scenes", conf["scene"]["maker"])
    tris_np = maker.make(**conf["scene"]["args"])
    scene = build_tight_scene(*tris_np, **conf.get("build", {}))
    tris = tuple(torch.from_numpy(x).to(device) for x in tris_np)
    return tris_np, tris, scene, cell.entry.make(scene, tris_np, device,
                                                 cell.traffic["entry"])


def check_sample(pool, labels, kept, seed: int, per_slot: int, device):
    """The rows the check reads, drawn from the seed, and the answers that
    the window gave them: per kept slot ``per_slot`` rows, concatenated."""
    g = torch.Generator().manual_seed((seed + 1) % (1 << 63))
    rows, outs = [], []
    for slot in sorted(kept):
        idx = check.sample_rows(labels[slot], pool[slot][0].shape[0],
                                per_slot, g).to(device)
        rows.append(tuple(x[idx] for x in pool[slot]))
        outs.append(tuple(y[idx] for y in kept[slot]))
    return (tuple(torch.cat(c) for c in zip(*rows)),
            tuple(torch.cat(c) for c in zip(*outs)))


def work_sample(pool, seed: int, device):
    """The work model's sample: ``model.SAMPLE`` rays or points over the
    pool's batches, drawn from the seed."""
    g = torch.Generator().manual_seed((seed + 2) % (1 << 63))
    k = model.SAMPLE // len(pool)
    picks = []
    for b in pool:
        idx = torch.randperm(b[0].shape[0], generator=g)[:k].to(device)
        picks.append(tuple(x[idx] for x in b))
    return tuple(torch.cat(c) for c in zip(*picks))


def spans_stretch(call, pool, seconds: float, device) -> dict:
    """``SPAN_PAIRS`` turns of an unprofiled stretch with the program's
    spans off and one with them on, ``seconds`` in all: the on stretches'
    spans a batch (path: ``self_ms``, ``total_ms``, ``n``), the counters a
    batch, and ``tracing_on_cost_pct``, the median over the turns of the
    on stretch's mean batch against the off one's. Turns, since the host's
    speed drifts from one second to the next."""
    from bvh_tpu_torch import obs

    part = seconds / (2 * SPAN_PAIRS)

    def stretch():
        _, n, wall = devtrace.closed_loop(call, pool, part,
                                          lambda: _sync(device), False)
        return n, wall

    obs.reset()
    n_on, n_all, cost = 0, 0, []
    for _ in range(SPAN_PAIRS):
        n_off, wall_off = stretch()
        with obs.tracing():
            n, wall = stretch()
        n_on += n
        n_all += n_off + n
        cost.append((wall / n) / (wall_off / n_off) - 1.0)
    snap = obs.snapshot()
    obs.reset()
    # spans count in the on stretches, counters in every batch
    return {"spans": {p: {"self_ms": r["self_s"] / n_on * 1e3,
                          "total_ms": r["total_s"] / n_on * 1e3,
                          "n": r["n"] / n_on}
                      for p, r in sorted(snap["spans"].items())},
            "counts": {k: v / n_all for k, v in sorted(snap["counts"].items())},
            "tracing_on_cost_pct": 100.0 * statistics.median(cost)}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, wrap=None) -> dict:
    """Runs ``cell`` once on ``device`` and returns the result line as a
    dict. ``t_start``: the process's start on ``time.perf_counter``'s
    clock. ``wrap``: a function of the timed call that returns the call to
    time in its place (tests put faults and the control there)."""
    device = torch.device(device)
    mix, entry = cell.traffic, cell.entry
    parts = {"start": time.perf_counter() - t_start}
    tris_np, tris, scene, call = build(cell, device)
    parts["scene"] = time.perf_counter() - t_start
    pool, labels = traffic.make_pool(mix, tris, seed, device, entry.INPUTS,
                                     cell.root)
    _sync(device)
    parts["pool"] = time.perf_counter() - t_start
    if wrap is not None:
        call = wrap(call)
    for batch in pool + pool[:2]:  # warm-up: every slot, then two more
        call(batch)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    red = None
    if trace:
        from bvh_tpu_torch import obs

        # the profiler slows the host, also after it has stopped (the aimed
        # cell: 3.4 -> 4.5 ms a batch), so the wall time a batch that the
        # idle share divides by comes from an unprofiled stretch of the
        # same length before it, spans off as in the timed window; then
        # stretches with spans on for the stages' host times. The
        # labelling stretch runs with spans on, so that its trace holds the
        # stages; the device-only stretch, whose times the kernels' metrics
        # read, with spans off
        stretch = min(seconds, TRACE_SECONDS)
        win = _window(call, pool, stretch, device)
        prog = spans_stretch(call, pool, stretch, device)
        red, kept, n = devtrace.profile_stretch(call, pool, stretch,
                                                lambda: _sync(device),
                                                obs.tracing)
        if red is not None:
            red["untraced_wall_ms"] = float(np.mean(win["times"])) * 1e3
    else:
        win = _window(call, pool, seconds, device)
        kept, n = win["kept"], len(win["times"])
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    # the sample to check, then the work model's sample, then free the
    # program's state before the reference runs
    rows, outs = check_sample(pool, labels, kept, seed,
                              int(mix["check"]["per_slot"]), device)
    work_rows = work_sample(pool, seed, device) if trace else None
    batch_units = pool[0][0].shape[0]
    del pool, kept, call, scene, labels, win["kept"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    correct, checks = check.judge(entry.numbers(rows, outs, tris), cell.limits)
    metrics = {}
    if trace:
        bnd = None
        if red is not None and entry.WORK in ("rays", "points"):
            points = entry.WORK == "points"
            cache = cell.root / "portbench" / "_cache" / "work"
            tree = model.tree(tris_np, cache)
            cnt = model.counts(tree, tris, work_rows, points, cache,
                               (cell.name, seed, model.SAMPLE))
            bnd = model.bound(cnt, batch_units, tris[0].shape[0], points)
        for m in cell.per_layer:
            # spans and stages a batch, keyed by the program's span path
            ctx = SimpleNamespace(name=m["name"], trace=red, bound=bnd,
                                  window=win, spans=prog["spans"],
                                  stages=None if red is None
                                  else red["stages"])
            v = None if red is None else reader(cell.root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        times = win["times"]
        e2e = {"setup_s": setup_s,
               "batch_ms_p95": float(np.percentile(times, 95)) * 1e3,
               f"{mix['unit']}_per_s": n * batch_units / win["seconds"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else device.type),
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    # seconds from the process's start to the end of each set-up step
    dev_info["setup_marks_s"] = {**parts, "warm": setup_s}
    if not trace:
        # where a batch's wall time goes: the host's call (launching), the
        # device's span, and the host CPU the loop ended on
        half = len(times) // 2
        dev_info["window"] = {
            "batch_ms_p05_p50_p95": _percentiles(times, 1e3),
            "halves_ms": [float(np.mean(times[:half])) * 1e3,
                          float(np.mean(times[half:])) * 1e3],
            "call_ms_p05_p50_p95": _percentiles(win["calls"], 1e3),
            "span_ms_p05_p50_p95": _percentiles(win["spans"], 1.0),
            "host_cpu": _host_cpu()}
    result = {"correct": bool(correct), "attempted": n, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if trace:
        dev_info.update(prog)
    if trace and red is not None:
        dev_info["stages"] = red["stages"]
        dev_info["busy_s"] = red["busy_s"]
        dev_info["window_s"] = red["window_s"]
        result["breakdown"] = {"device_ops": red["device_ops"],
                               "idle_gaps": red["idle_gaps"]}
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]} for k, v in checks.items()}
    return result


def _percentiles(xs, scale: float):
    """The 5th, 50th and 95th percentiles of ``xs`` times ``scale``, or None
    for no values."""
    if not len(xs):
        return None
    return (np.percentile(xs, [5, 50, 95]) * scale).tolist()
