"""The device trace of a traced run: torch.profiler over steady stretches of
batches, reduced to device time by layer and by the program's stage, busy
time, idle gaps and the breakdown.

Two stretches. The first records the host's operators and the program's
stage ranges (``bvh.<path>``, open while the program's spans are on)
beside the device. It tells the program's kernels from PyTorch's: a
device operation is PyTorch's when it is a copy or a fill, or when the
runtime call that launched it lies inside an ``aten::`` operator on the
host; every other kernel is the program's own. The rule reads where a
launch came from, not what the kernel is called, so a renamed or new
kernel of the program still counts as its own. It places every device
operation in the innermost stage that launched it, and labels the idle
gaps by what the host was doing (``classify_stages``). Recording every
host operator slows the host, so the times come from the second stretch,
which records the device alone and classes its kernels by the first
stretch's names.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIXES = ("portbench.", "bvh.")  # the benchmark's, the program's
LABEL_SECONDS = 0.3  # the first stretch, at least
TOP = 10  # entries of each breakdown list


def closed_loop(call, pool, min_seconds: float, sync, annotate: bool):
    """The closed loop over ``pool`` for ``min_seconds`` and one pass:
    (kept answers by slot, batches, wall seconds)."""
    from torch.profiler import record_function

    kept, n = {}, 0
    t0 = time.perf_counter()
    while n < len(pool) or time.perf_counter() - t0 < min_seconds:
        slot = n % len(pool)
        if annotate:
            with record_function("portbench.batch"):
                with record_function("portbench.call"):
                    out = call(pool[slot])
                with record_function("portbench.sync"):
                    sync()
        else:
            out = call(pool[slot])
            sync()
        kept[slot] = out
        n += 1
    return kept, n, time.perf_counter() - t0


def _events(prof) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def profile_stretch(call, pool, min_seconds: float, sync, spans,
                    attempts: int = 3):
    """Profiles the closed loop (``sync()`` after each call): a labelling
    stretch inside ``spans()`` (the program's spans on), then a device-only
    stretch of at least ``min_seconds`` outside it. Returns ``(reduced
    trace or None, kept answers by slot, batches)`` of the last stretch;
    None without a card, or where every one of ``attempts`` tries lost
    device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    host = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _ in range(attempts):
        with spans(), profile(activities=host) as prof:
            kept, n, _ = closed_loop(call, pool, LABEL_SECONDS, sync, True)
        labels = classify(_events(prof))
        if labels is None:
            continue
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kept, n, wall = closed_loop(call, pool, min_seconds, sync, False)
        red = reduce_device(_events(prof), labels, wall, n)
        if red is not None:
            return red, kept, n
    return None, kept, n


def _union(intervals):
    """Merged, sorted [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(merged, starts, x) -> bool:
    i = bisect.bisect_right(starts, x) - 1
    return i >= 0 and merged[i][0] <= x <= merged[i][1]


def _innermost(spans, starts, x):
    """The innermost of properly nested ``spans`` (sorted by start, the
    longer first) that covers ``x``, or None."""
    i = bisect.bisect_right(starts, x) - 1
    while i >= 0:
        s, e, name = spans[i]
        if e >= x:
            return name
        i -= 1
    return None


def _parse(events: list):
    """(launches by correlation, host operators by thread, the benchmark's
    and the program's ranges, device operations) of a Chrome trace's
    complete events (µs)."""
    launches, ops, ann, dev = {}, defaultdict(list), [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launches[args["correlation"]] = (e["tid"], ts, e["name"])
        elif cat == "cpu_op":
            ops[e["tid"]].append((ts, ts + dur, e["name"]))
        elif (cat == "user_annotation"
              and e["name"].startswith(SPAN_PREFIXES)):
            ann.append((ts, ts + dur, e["name"], e["tid"]))
        elif cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e["name"], cat, args.get("correlation")))
    return launches, ops, ann, dev


def _complete(launches, dev) -> bool:
    """Whether every kernel launch has its kernel and every kernel its
    launch (the profiler has been seen to drop some)."""
    kernels = [d for d in dev if d[3] == "kernel"]
    n_launch = sum(1 for _, _, name in launches.values()
                   if "LaunchKernel" in name)
    return n_launch == len(kernels) and all(d[4] in launches
                                            for d in kernels)


def _lineage(path: str) -> list:
    """``trace/walk`` -> ``["trace", "trace/walk"]``."""
    parts = path.split("/")
    return ["/".join(parts[:i + 1]) for i in range(len(parts))]


def _nested(spans) -> tuple:
    """``spans`` sorted for ``_innermost``, and their starts."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))  # the outer first
    return spans, [s[0] for s in spans]


def classify_stages(events: list) -> dict | None:
    """From a host-and-device trace of batches: for each span path of the
    program (``bvh.<path>`` ranges), ms a batch of the device operations
    launched inside it (by the launch's correlation and host time), those
    operations a batch, and the idle ms a batch whose middle falls while
    the batch's thread was inside it; a path counts what its children do.
    ``idle_gaps``: the gaps in the device's work inside the batches, in
    seconds, labelled by the innermost of the benchmark's spans, the
    program's and the host's operators that the batch's thread was in at
    the gap's middle. None when the trace holds no batch or no kernel, or
    lost a kernel."""
    launches, ops, ann, dev = _parse(events)
    batches = [a for a in ann if a[2] == "portbench.batch"]
    if not batches or not any(d[3] == "kernel" for d in dev):
        return None
    if not _complete(launches, dev):
        return None
    tid = batches[0][3]
    prog, prog_starts = _nested([(s, e, n[len("bvh."):])
                                 for s, e, n, t in ann
                                 if t == tid and n.startswith("bvh.")])
    acc = {p: [0.0, 0, 0.0] for _, _, p in prog}  # device us, ops, idle us
    for s, e, _, _, corr in dev:
        launch = launches.get(corr)
        if launch is None or launch[0] != tid:
            continue
        inner = _innermost(prog, prog_starts, launch[1])
        for p in _lineage(inner) if inner else ():
            acc[p][0] += e - s
            acc[p][1] += 1
    w0 = min(b[0] for b in batches)
    w1 = max(b[1] for b in batches)
    busy = _union([(max(s, w0), min(e, w1)) for s, e, *_ in dev
                   if min(e, w1) > max(s, w0)])
    labels, label_starts = _nested(
        [(s, e, n) for s, e, n, t in ann if t == tid]
        + [(s, e, n) for s, e, n in ops.get(tid, [])])
    marks = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = defaultdict(float)
    for g0, g1 in zip(marks[0::2], marks[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        inner = _innermost(prog, prog_starts, mid)
        for p in _lineage(inner) if inner else ():
            acc[p][2] += g1 - g0
        label = _innermost(labels, label_starts, mid)
        gaps[label or "outside spans"] += g1 - g0
    n = len(batches)
    return {"batches": n,
            "stages": {p: {"device_ms": us / n * 1e-3, "launches": k / n,
                           "idle_ms": idle / n * 1e-3}
                       for p, (us, k, idle) in sorted(acc.items())},
            "idle_gaps": [[k, v * 1e-6] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:TOP]]}


def classify(events: list) -> dict | None:
    """From a host-and-device trace: ``{"mine": {kernel name: whether the
    program launched it}}`` and ``classify_stages``'s ``stages`` and
    ``idle_gaps``. None where ``classify_stages`` gives None."""
    stages = classify_stages(events)
    if stages is None:
        return None
    launches, ops, _, dev = _parse(events)
    aten = {}
    for tid, lst in ops.items():
        merged = _union([(s, e) for s, e, name in lst
                         if name.startswith("aten::")])
        aten[tid] = (merged, [m[0] for m in merged])
    mine = {}
    for s, e, name, cat, corr in dev:
        if cat != "kernel":
            continue
        tid, t_launch, _ = launches[corr]
        merged, starts = aten.get(tid, ([], []))
        mine[name] = not _inside(merged, starts, t_launch)
    return {"mine": mine, **stages}


def reduce_device(events: list, labels: dict, wall_s: float,
                  batches: int) -> dict | None:
    """From a device-only trace of ``batches`` batches over ``wall_s``
    seconds of the host's clock: busy seconds, the program's and PyTorch's
    device ms a batch (kernels classed by ``labels["mine"]``; copies and
    fills are PyTorch's), the breakdown, and the labelling stretch's
    ``stages``. None when a kernel is missing from the labels, or the
    trace lost one."""
    launches, _, _, dev = _parse(events)
    if not dev or (launches and not _complete(launches, dev)):
        return None
    mine = labels["mine"]
    port_us = torch_us = 0.0
    by_name = defaultdict(float)
    for s, e, name, cat, _ in dev:
        if cat == "kernel" and name not in mine:
            return None
        by_name[name] += e - s
        if cat == "kernel" and mine[name]:
            port_us += e - s
        else:
            torch_us += e - s
    busy_s = sum(e - s for s, e in _union([d[:2] for d in dev])) * 1e-6
    return {
        "batches": batches, "window_s": wall_s, "busy_s": busy_s,
        "port_ms": port_us / batches * 1e-3,
        "torch_ms": torch_us / batches * 1e-3,
        "device_ops": [[k, v * 1e-6] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": labels["idle_gaps"],
        "stages": labels["stages"],
    }
