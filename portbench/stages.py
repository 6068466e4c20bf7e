"""Per-stage numbers of one cell from the program's own spans and counters
(``bvh_tpu_torch.obs``): where a batch's host time, device work, launches
and idle time go inside the entry (``sort``, ``prologue``, ``walk`` and
``epilogue`` under ``trace`` or ``nearest``), and what the spans cost.

    python3 portbench/stages.py --workload cubes120k.aimed --seed 7 \
        --seconds 1

One process on the card. The cell's scene, pool and warm-up are
``run.py``'s. Then, in turns, ``PAIRS`` unprofiled stretches of
``--seconds`` each with spans off and on: the on-stretches' spans and
counters a batch give the host numbers, and their wall time against the
off-stretches' the spans' cost. Then, spans still on, a stretch profiled
with host and device, whose ``bvh.*`` ranges place every device
operation in the stage that launched it and every idle gap in the stage
the host was in (``classify_stages``), and a device-only stretch
(``devtrace``'s kernel and PyTorch times). Prints one JSON line: the
stage metrics through their readers (``layers/span_host_ms.py``,
``layers/span_device_ms.py``, ``layers/launches.py``), the spans, the
counters and the stages a batch, the idle gaps labelled by the innermost
stage, ``tracing_on_cost_pct``, and two sums that hold the spans against
the outside measurements.

``run.py --trace 1`` does not run this: its readers get no spans yet
(PERF.md, open questions). The tool is temporary: ``_parse`` copies
``devtrace._parse`` but for the prefixes, and ``measure`` and ``run``
repeat the harness's build, pool and warm-up through its private
functions. Once ``devtrace`` keeps ``bvh.`` ranges and calls
``classify_stages`` from ``classify``, and ``harness.run_cell`` runs the
spans-on stretch, all of this file but ``classify_stages`` goes.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PAIRS = 5  # off and on stretches, in turns
STAGES = ("sort", "prologue", "walk", "epilogue")
DEVICE_STAGES = ("sort", "prologue", "epilogue")  # the walk's is kernel_ms
SPAN_PREFIXES = ("bvh.", "portbench.")


def metric_names(top: str) -> list:
    """The stage metrics of an entry whose top span is ``top``."""
    return ([f"span_host_ms.{top}.{s}" for s in STAGES]
            + [f"span_device_ms.{top}.{s}" for s in DEVICE_STAGES]
            + [f"launches.{top}"])


def _parse(events: list):
    """``devtrace._parse`` that keeps the program's ``bvh.`` ranges beside
    the benchmark's ``portbench.`` ones."""
    from portbench import devtrace

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
        elif cat in devtrace.DEVICE_CATS:
            dev.append((ts, ts + dur, e["name"], cat, args.get("correlation")))
    return launches, ops, ann, dev


def _lineage(path: str) -> list:
    """``trace/walk`` -> ``["trace", "trace/walk"]``."""
    parts = path.split("/")
    return ["/".join(parts[:i + 1]) for i in range(len(parts))]


def _nested(spans) -> tuple:
    """``spans`` sorted for ``devtrace._innermost``, and their starts."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))  # the outer first
    return spans, [s[0] for s in spans]


def classify_stages(events: list) -> dict | None:
    """From a host-and-device trace of batches run with spans on: for each
    span path of the program, ms a batch of the device operations launched
    inside it (by the launch's correlation and host time), those
    operations a batch, and the idle ms a batch whose middle falls while
    the batch's thread was inside it; a path counts what its children do.
    ``idle_gaps``: the gaps in seconds labelled by the innermost of the
    benchmark's spans, the program's and the host's operators, as
    ``devtrace.classify`` labels them with the program's spans among the
    candidates. None when the trace holds no batch or no kernel, or lost
    a kernel."""
    from portbench import devtrace

    launches, ops, ann, dev = _parse(events)
    batches = [a for a in ann if a[2] == "portbench.batch"]
    if not batches or not any(d[3] == "kernel" for d in dev):
        return None
    if not devtrace._complete(launches, dev):
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
        inner = devtrace._innermost(prog, prog_starts, launch[1])
        for p in _lineage(inner) if inner else ():
            acc[p][0] += e - s
            acc[p][1] += 1
    w0 = min(b[0] for b in batches)
    w1 = max(b[1] for b in batches)
    busy = devtrace._union([(max(s, w0), min(e, w1)) for s, e, *_ in dev
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
        inner = devtrace._innermost(prog, prog_starts, mid)
        for p in _lineage(inner) if inner else ():
            acc[p][2] += g1 - g0
        label = devtrace._innermost(labels, label_starts, mid)
        gaps[label or "outside spans"] += g1 - g0
    n = len(batches)
    return {"batches": n,
            "stages": {p: {"device_ms": us / n * 1e-3, "launches": k / n,
                           "idle_ms": idle / n * 1e-3}
                       for p, (us, k, idle) in sorted(acc.items())},
            "idle_gaps": [[k, v * 1e-6] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:devtrace.TOP]]}


def _add(total: dict, snap: dict) -> None:
    """Adds one ``obs.snapshot()`` into ``total``."""
    for p, r in snap["spans"].items():
        t = total["spans"].setdefault(p, {"n": 0, "total_s": 0.0,
                                          "self_s": 0.0})
        for k in t:
            t[k] += r[k]
    for k, v in snap["counts"].items():
        total["counts"][k] = total["counts"].get(k, 0) + v


def _bits_equal(a: dict, b: dict) -> bool:
    """Whether two windows' kept answers agree bit for bit, slot by slot."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    return all(torch.equal(bits(x), bits(y))
               for s in a for x, y in zip(a[s], b[s]))


def measure(call, pool, seconds: float, device, pairs: int = PAIRS) -> dict:
    """The spans, counters, stages and on-cost of ``call`` over ``pool``
    (warmed up) on ``device``: ``pairs`` turns of an unprofiled stretch of
    ``seconds`` with spans off and one with spans on, then the profiled
    stretches with spans on."""
    from bvh_tpu_torch import obs

    from portbench import harness

    def sync():
        harness._sync(device)

    total = {"spans": {}, "counts": {}}
    cost, call_cost, n_on, calls_s, equal = [], [], 0, 0.0, True
    for _ in range(pairs):
        win_off = harness._window(call, pool, seconds, device)
        obs.reset()
        with obs.tracing():
            win_on = harness._window(call, pool, seconds, device)
        _add(total, obs.snapshot())
        equal &= _bits_equal(win_off.pop("kept"), win_on.pop("kept"))
        n_on += len(win_on["times"])
        calls_s += sum(win_on["calls"])
        # medians, so that a stall in one stretch does not read as cost
        for key, out in (("times", cost), ("calls", call_cost)):
            out.append(100.0 * (statistics.median(win_on[key])
                                / statistics.median(win_off[key]) - 1.0))
    spans = {p: {"n": r["n"] / n_on, "total_ms": r["total_s"] / n_on * 1e3,
                 "self_ms": r["self_s"] / n_on * 1e3}
             for p, r in sorted(total["spans"].items())}
    counts = {k: v / n_on for k, v in sorted(total["counts"].items())}
    stages, red = None, None
    with obs.tracing():
        for _ in range(3):  # the profiler has been seen to drop events
            st, red = _profiled(call, pool, seconds, sync)
            if st is not None and red is not None:
                stages = st
                break
    return {"spans": spans, "counts": counts, "stages": stages,
            "trace": red, "outputs_bit_equal": bool(equal),
            "call_ms_on": calls_s / n_on * 1e3,
            "span_us_off_on": span_cost_us(),
            "tracing_on_cost_pct": statistics.median(cost),
            "tracing_on_cost_pct_pairs": cost,
            "tracing_on_call_cost_pct": statistics.median(call_cost)}


def span_cost_us(n: int = 20000) -> list:
    """Host µs of one empty span entered and left, with spans off and on
    (no profiler): the spans' own cost, which a stretch's wall time shows
    only through its noise."""
    from bvh_tpu_torch import obs

    out = []
    for on in (False, True):
        obs.reset()
        if on:
            obs.enable()
        t0 = time.perf_counter()
        for _ in range(n):
            with obs.span("cost"):
                pass
        out.append((time.perf_counter() - t0) / n * 1e6)
        obs.disable()
    obs.reset()
    return out


def _profiled(call, pool, seconds: float, sync):
    """One labelling stretch (host and device) and one device-only stretch
    of ``devtrace``: (``classify_stages`` of the first, ``devtrace``'s
    reduction of the second); None for what the profiler left whole."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import devtrace

    if not torch.cuda.is_available():
        return None, None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        devtrace._loop(call, pool, devtrace.LABEL_SECONDS, sync, True)
    events = devtrace._events(prof)
    labels = devtrace.classify(events)
    stages = classify_stages(events)
    if labels is None or stages is None:
        return None, None
    stages["idle_gaps_without_stages"] = labels["idle_gaps"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, n, wall = devtrace._loop(call, pool, seconds, sync, False)
    return stages, devtrace.reduce_device(devtrace._events(prof), labels,
                                          wall, n)


def top_span(spans: dict) -> str | None:
    """The entry's top span: the root path entered most."""
    roots = {p: r["n"] for p, r in spans.items() if "/" not in p}
    return max(roots, key=roots.get) if roots else None


def report(m: dict) -> dict:
    """The stage metrics through their readers, and the two sums: the top
    span's host total over the spans-on call time, and the stages' device
    ms with the program's kernels over the kernels and PyTorch's."""
    from portbench import harness

    top = top_span(m["spans"])
    stages = m["stages"]["stages"] if m["stages"] else None
    metrics = {}
    for name in metric_names(top) if top else ():
        ctx = SimpleNamespace(name=name, spans=m["spans"], stages=stages,
                              trace=m["trace"], bound=None, window=None)
        v = harness.reader(ROOT, name)(ctx)
        if v is not None:
            metrics[name] = v
    sums = {}
    if top:
        sums["host_top_over_call"] = (m["spans"][top]["total_ms"]
                                      / m["call_ms_on"])
    if top and stages and m["trace"]:
        dev = sum(stages.get(f"{top}/{s}", {}).get("device_ms", 0.0)
                  for s in DEVICE_STAGES)
        red = m["trace"]
        sums["device_stages_over_outside"] = (
            (dev + red["port_ms"]) / (red["port_ms"] + red["torch_ms"]))
    return {"top": top, "metrics": metrics, "sums": sums}


def run(cell, seed: int, seconds: float, device, t_start: float) -> dict:
    """``cell``'s scene, pool and warm-up as ``harness.run_cell`` makes
    them, then ``measure`` and ``report``."""
    from portbench import harness, traffic

    tris_np, tris, scene, call = harness.build(cell, device)
    pool, _ = traffic.make_pool(cell.traffic, tris, seed, device,
                                cell.entry.INPUTS, cell.root)
    for batch in pool + pool[:2]:
        call(batch)
    harness._sync(device)
    setup_s = time.perf_counter() - t_start
    m = measure(call, pool, seconds, device)
    out = {"workload": cell.name, "seed": seed, "setup_s": setup_s,
           **report(m), **m}
    out.pop("trace")
    out["kernel_ms"] = m["trace"]["port_ms"] if m["trace"] else None
    out["torch_ops_ms"] = m["trace"]["torch_ms"] if m["trace"] else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"portbench: {args.workload} needs a CUDA device",
              file=sys.stderr)
        return 2
    res = run(cell, args.seed, args.seconds, torch.device("cuda", 0),
              T_START)
    res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
