"""CPU tests of the port's benchmark: every name resolves to its files, a
cell (with a scene, a configuration and inputs of its own) is added by
files and entries alone, each mix runs end to end at a tiny size against
the reference, the control and the planted faults come out not correct,
a traced run hands its readers the program's spans and stages, and
nothing loads JAX or the JAX package.

Run: ``python -m pytest portbench/tests -q`` from the repository root.
"""

from __future__ import annotations

import ast
import hashlib
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import devtrace, harness, plugin, traffic
from portbench.tests.test_portbench_work import synthetic_trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
STAGES = ("sort", "prologue", "walk", "epilogue")


def small_cell(name: str, root: Path = ROOT) -> harness.Cell:
    """The cell at a size the CPU runs in a second: the tiny scene its
    maker names (``SMALL``), batches of 1,024 rays or points, two of them,
    128 checked a batch; a second part's share raised to 1/8 so that its
    stratum holds enough rays to check."""
    c = harness.load_cell(name, root)
    maker = plugin(root, "scenes", c.config["scene"]["maker"])
    c.config["scene"]["args"] = dict(maker.SMALL)
    c.traffic["batch"] = 1024
    c.traffic["pool"] = 2
    c.traffic["check"]["per_slot"] = 128
    for p in c.traffic["parts"][1:]:
        p["share"] = 0.125
    return c


def run_small(cell: harness.Cell, seed: int = 2**31 + 11, trace: bool = False,
              wrap=None) -> dict:
    return harness.run_cell(cell, seed, 0.2, trace, "cpu",
                            time.perf_counter(), wrap=wrap)


def test_every_name_finds_its_files():
    for conf in BENCH["configs"]:
        data = json.loads((ROOT / conf["file"]).read_text())
        assert data["name"] == conf["name"]
        assert data["reduced"] == conf["reduced"]
        maker = plugin(ROOT, "scenes", data["scene"]["maker"])
        assert callable(maker.make) and isinstance(maker.SMALL, dict)
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(ROOT, m["name"])), m["name"]
    for name in CELLS:
        cell = harness.load_cell(name)
        for part in cell.traffic["parts"]:
            assert callable(plugin(ROOT, "kinds", part["kind"]).make)
        assert set(cell.limits) == set(cell.entry.NUMBERS)
        names = {m["name"] for m in cell.end_to_end}
        assert {"setup_s", "batch_ms_p95",
                f"{cell.traffic['unit']}_per_s"} == names
        assert cell.per_layer, name
        for m in cell.per_layer:
            assert m["moves"] in names


def _tree_hashes(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


FAR_KIND = """
import torch


def make(n, g, part, ctx):
    # from near the scene's middle towards triangle centroids far away
    a, b, c = ctx["tris"]
    cen = (a + b + c) / 3
    o = (torch.rand((n, 3), generator=g, device=ctx["device"]) * 2 - 1)
    o = o * float(part["spread"])
    pick = torch.randint(0, a.shape[0], (n,), generator=g,
                         device=ctx["device"])
    return o, cen[pick] - o
"""

HALVES_ENTRY = """
from pathlib import Path

import torch

from portbench import plugin

BASE = plugin(Path(__file__).resolve().parents[2], "entries", "tracer")
INPUTS, WORK, NUMBERS = BASE.INPUTS, BASE.WORK, BASE.NUMBERS
reference, numbers = BASE.reference, BASE.numbers


def make(scene, tris_np, device, spec):
    # the tracer called on each half of a batch in turn
    call = BASE.make(scene, tris_np, device, spec)

    def halves(batch):
        k = batch[0].shape[0] // 2
        lo = call(tuple(x[:k] for x in batch))
        hi = call(tuple(x[k:] for x in batch))
        return tuple(torch.cat(p) for p in zip(lo, hi))
    return halves
"""


SIERPINSKI_SCENE = """
import numpy as np

SMALL = {"depth": 3}  # 64 tetrahedra, 256 triangles

# a regular tetrahedron's corners, and its faces wound outwards
CORNERS = np.array([[1, 1, 1], [-1, -1, 1], [-1, 1, -1], [1, -1, -1]],
                   np.float64)
FACES = [[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]]


def make(depth, size=1.0):
    # a Sierpinski tetrahedron: 4**depth corner tetrahedra, 4 triangles each
    tets = CORNERS[None] * size
    for _ in range(depth):
        tets = ((tets[:, :, None] + tets[:, None]) / 2).reshape(-1, 4, 3)
    tris = tets[:, FACES].reshape(-1, 3, 3).astype(np.float32)
    return tris[:, 0].copy(), tris[:, 1].copy(), tris[:, 2].copy()
"""

BOUNDED_KIND = """
import torch


def make(n, g, part, ctx):
    # from ``dist`` away towards triangle centroids, each ray bounded at a
    # t_max between 0.2 and 1.8 times its way to the centroid
    a, b, c = ctx["tris"]
    dev = ctx["device"]
    cen = (a + b + c) / 3
    pick = torch.randint(0, a.shape[0], (n,), generator=g, device=dev)
    off = torch.randn((n, 3), generator=g, device=dev)
    off = off / torch.linalg.vector_norm(off, dim=1, keepdim=True)
    dist = float(part["dist"])
    o = cen[pick] + dist * off
    t_max = dist * (0.2 + 1.6 * torch.rand((n,), generator=g, device=dev))
    return o, cen[pick] - o, t_max
"""

BOUNDED_ENTRY = """
import math

import torch

from portbench.check import worst
from portbench.reference import hits

INPUTS = 3  # a batch is (origins, directions, t_max)
WORK = None  # no work model: no bound, no roofline
NUMBERS = ("flips", "t_err")


def make(scene, tris_np, device, spec):
    from bvh_tpu_torch.ops.trace import trace_closest_hit_tight
    from bvh_tpu_torch.ray import Ray

    def call(batch):
        o, d, t_max = batch
        h = trace_closest_hit_tight(scene, Ray.create(o, d, device=device),
                                    t_max=t_max, device=device)
        return h.t, h.shape_id
    return call


def reference(rows, tris, dtype=torch.float64):
    t, i = hits.closest_hits(rows[0], rows[1], tris, dtype=dtype)
    cut = t >= rows[2].to(t.dtype)
    return torch.where(cut, math.inf, t), torch.where(cut, -1, i)


def numbers(rows, out, tris):
    t_ref, _ = reference(rows, tris)
    value = out[0].double()
    hit_p, hit_r = torch.isfinite(value), torch.isfinite(t_ref)
    both = hit_p & hit_r
    return {"flips": float((hit_p != hit_r).double().mean()),
            "t_err": worst((value[both] - t_ref[both]).abs() / t_ref[both])}
"""


def inject_profile(mp, top: str = "trace") -> list:
    """Puts a stand-in for ``torch.profiler.profile`` and the synthetic
    trace of ``top`` (``devtrace._events``) in the profiler's place, so
    that a traced run on the CPU reads a device trace. Returns the list to
    which each profiled stretch appends whether the program's spans were
    on in it."""
    from bvh_tpu_torch import obs

    spans_on = []

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            spans_on.append(obs._on)
            return self

        def __exit__(self, *exc):
            return False

    mp.setattr(torch.profiler, "profile", Profile)
    mp.setattr(devtrace, "_events", lambda prof: synthetic_trace(top))
    return spans_on


def unbounded(call):
    """Drops each ray's t_max: the third input left unread."""
    def f(batch):
        return call((*batch[:2], torch.full_like(batch[2], math.inf)))
    return f


def _add_far_cell(pkg: Path, bench: dict) -> tuple:
    """A traffic kind, a mix and an entry kind of their own on the cubes."""
    (pkg / "kinds/far_centroids.py").write_text(FAR_KIND)
    (pkg / "entries/tracer_halves.py").write_text(HALVES_ENTRY)
    mix = json.loads((pkg / "traffic/aimed.json").read_text())
    mix["parts"] = [{"kind": "far_centroids", "share": 1.0, "spread": 60.0}]
    mix["entry"]["kind"] = "tracer_halves"
    (pkg / "traffic/far.json").write_text(json.dumps(mix))
    # far rays: the limits of the cell whose check holds far rays
    shutil.copy(pkg / "cells/cubes120k.random.json",
                pkg / "cells/cubes120k.far.json")
    bench["workloads"].append({"name": "cubes120k.far",
                               "config": "cubes120k", "traffic": "far",
                               "chips": 1, "why": "far rays, halved"})
    return "cubes120k.far", "tracer_halves", (half,)


def _add_scene_cell(pkg: Path, bench: dict) -> tuple:
    """A scene maker and its configuration, a kind whose rows carry a third
    array (t_max) and an entry that reads it, with no work model."""
    (pkg / "scenes/sierpinski.py").write_text(SIERPINSKI_SCENE)
    (pkg / "kinds/bounded_centroids.py").write_text(BOUNDED_KIND)
    (pkg / "entries/bounded.py").write_text(BOUNDED_ENTRY)
    (pkg / "configs/sierpinski6.json").write_text(json.dumps(
        {"name": "sierpinski6", "reduced": [], "precision": "float32",
         "scene": {"maker": "sierpinski", "args": {"depth": 6}},
         "build": {}}))
    (pkg / "traffic/bounded.json").write_text(json.dumps(
        {"unit": "rays", "batch": 1048576, "pool": 8,
         "parts": [{"kind": "bounded_centroids", "share": 1.0, "dist": 4.0}],
         "entry": {"kind": "bounded"}, "check": {"per_slot": 512}}))
    (pkg / "cells/sierpinski6.bounded.json").write_text(json.dumps(
        {"limits": {"flips": 0.0005, "t_err": 0.0001}}))
    bench["configs"].append({
        "name": "sierpinski6",
        "source": "https://github.com/erich666/StandardProceduralDatabases",
        "file": "portbench/configs/sierpinski6.json", "reduced": [],
        "why": "a Sierpinski tetrahedron"})
    bench["workloads"].append({"name": "sierpinski6.bounded",
                               "config": "sierpinski6", "traffic": "bounded",
                               "chips": 1, "why": "rays bounded by t_max"})
    return "sierpinski6.bounded", "bounded", (half, unbounded)


@pytest.mark.parametrize("add", [_add_far_cell, _add_scene_cell],
                         ids=["kind_mix_entry", "scene_config_inputs"])
def test_a_cell_is_added_by_files_and_entries_alone(tmp_path, monkeypatch,
                                                    add):
    """New files (a traffic kind, mix, entry kind and cell; or a scene
    maker, its configuration, a kind with a third per-row array and an
    entry that reads it, with ``WORK = None``) and entries in
    BENCHMARK.json: the small run is correct, planted faults are not, a
    traced run reads a roofline only with a work model, and no file that
    is there changes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    pkg = tmp_path / "portbench"
    before = _tree_hashes(pkg)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    name, entry, faults = add(pkg, bench)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cubes120k.aimed" in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = small_cell(name, tmp_path)
    assert cell.entry.__file__ == str(pkg / f"entries/{entry}.py")
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"rays_per_s", "batch_ms_p95", "setup_s"}
    assert res["checks"]["flips"]["value"] == 0.0
    for fault in faults:
        res = run_small(cell, wrap=fault)
        assert not res["correct"], (fault.__name__, res["checks"])
    inject_profile(monkeypatch)
    res = run_small(cell, trace=True)
    assert res["correct"] and "span_host_ms.trace.sort" in res["metrics"]
    assert (("trace_kernels_roofline" in res["metrics"])
            == (cell.entry.WORK is not None))
    after = _tree_hashes(pkg)
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.parametrize("name", CELLS)
def test_each_mix_runs_and_agrees_with_the_reference(name):
    res = run_small(small_cell(name))
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    m = res["metrics"]
    assert all(v["value"] > 0 for v in m.values()), m
    assert res["device"]["platform"] == "cpu"


def test_a_traced_run_checks_and_reads_no_device_metric_on_the_cpu():
    res = run_small(small_cell("cubes120k.aimed"), trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"] == {} and "busy_s" not in res["device"]


def counting(call):
    """Counts each batch in the program's registry, as a launch counts."""
    from bvh_tpu_torch import obs

    def f(batch):
        obs.count("batch")
        return call(batch)
    return f


def test_spans_on_stretches_give_each_stage_a_call_on_the_cpu():
    """The traced run's spans-on stretches: every stage of the entry once a
    batch, the counters a batch (every batch counts, spans on or off), no
    table upload, and the spans' cost; off the card no device trace, so no
    metric and no stages."""
    res = run_small(small_cell("cubes120k.nearest"), trace=True,
                    wrap=counting)
    dev = res["device"]
    assert res["correct"] and res["metrics"] == {} and "stages" not in dev
    spans = dev["spans"]
    for s in ("nearest",) + tuple(f"nearest/{x}" for x in STAGES):
        assert spans[s]["n"] == 1.0, s
    children = sum(spans[f"nearest/{x}"]["total_ms"] for x in STAGES)
    assert spans["nearest"]["self_ms"] == pytest.approx(
        spans["nearest"]["total_ms"] - children)
    assert dev["counts"]["batch"] == 1.0
    assert dev["counts"].get("table_upload", 0) == 0
    assert math.isfinite(dev["tracing_on_cost_pct"])


STAGE_METRICS = [(m["name"], m["workloads"][0]) for m in BENCH["per_layer"]
                 if m["name"].split(".")[0] in ("span_host_ms",
                                                "span_device_ms", "launches")]
SYNTHETIC_DEVICE_MS = {"sort": 0.010, "prologue": 0.0, "epilogue": 0.002}


@pytest.fixture(scope="module")
def injected():
    """A traced CPU run of a cell with the synthetic trace of its entry's
    top span in the profiler's place, the context each reader got, and
    whether the spans were on in each profiled stretch."""
    runs = {}

    def run(cell: str, top: str):
        if cell not in runs:
            seen, plain = {}, harness.reader

            def recording(root, name):
                read = plain(root, name)

                def rec(ctx):
                    seen[name] = ctx
                    return read(ctx)
                return rec
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(harness, "reader", recording)
                spans_on = inject_profile(mp, top)
                res = run_small(small_cell(cell), trace=True)
            runs[cell] = res, seen, spans_on
        return runs[cell]
    return run


@pytest.mark.parametrize("name,cell", STAGE_METRICS)
def test_the_traced_run_gives_readers_name_spans_and_stages(injected, name,
                                                            cell):
    """Each stage metric's reader gets its name and the run's spans and
    stages a batch, keyed by the program's span path, and reads them; the
    labelling stretch ran with the program's spans on, the device-only
    stretch with them off."""
    family, top, *stage = name.split(".")
    res, seen, spans_on = injected(cell, top)
    assert spans_on == [True, False]
    ctx = seen[name]
    assert ctx.name == name
    assert ctx.spans == res["device"]["spans"]
    assert ctx.stages == res["device"]["stages"]
    value = res["metrics"][name]["value"]
    path = "/".join([top, *stage])
    if family == "span_host_ms":
        assert value == ctx.spans[path]["self_ms"] > 0
        assert ctx.spans[path]["n"] == 1.0
    elif family == "span_device_ms":
        assert value == ctx.stages[path]["device_ms"]
        assert value == pytest.approx(SYNTHETIC_DEVICE_MS[stage[0]])
    else:
        assert value == ctx.stages[top]["launches"] == 3


def test_the_pool_is_a_function_of_the_seed():
    cell = small_cell("cubes120k.random")
    tris = tuple(torch.rand(600, 3) for _ in range(3))
    p1, l1 = traffic.make_pool(cell.traffic, tris, 5, "cpu", 2)
    p2, l2 = traffic.make_pool(cell.traffic, tris, 5, "cpu", 2)
    p3, _ = traffic.make_pool(cell.traffic, tris, 6, "cpu", 2)
    assert all(torch.equal(x, y) for a, b in zip(p1, p2) for x, y in zip(a, b))
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    assert not torch.equal(p1[0][0], p3[0][0])
    assert not torch.equal(p1[0][0], p1[1][0])  # the batches differ
    assert int((l1[0] == 1).sum()) == 128  # the aimed part's share


# ---- the control and the planted faults ------------------------------------

def control(cell: harness.Cell):
    """The reference in bfloat16, one step below the configuration's
    float32, put in the program's place."""
    maker = plugin(ROOT, "scenes", cell.config["scene"]["maker"])
    tris = tuple(torch.from_numpy(x)
                 for x in maker.make(**cell.config["scene"]["args"]))

    def wrap(call):
        def ctl(batch):
            v, i = cell.entry.reference(batch, tris, dtype=torch.bfloat16)
            return v.float(), i
        return ctl
    return wrap


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = small_cell(name)
    res = run_small(cell, wrap=control(cell))
    assert not res["correct"], res["checks"]


def stale(call):
    """Answers the previous batch's rays: the state left unchanged."""
    last = []

    def f(batch):
        out = call(batch)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return f


def half(call):
    """Leaves the second half of each batch unanswered."""
    def f(batch):
        v, i = (x.clone() for x in call(batch))
        v[v.shape[0] // 2:] = float("inf")
        i[i.shape[0] // 2:] = -1
        return v, i
    return f


def altered(call):
    """Alters every 16th answer where it is produced: the next triangle, a
    value 0.1% off."""
    def f(batch):
        v, i = (x.clone() for x in call(batch))
        v[::16] *= 1.001
        i[::16] += 1
        return v, i
    return f


@pytest.mark.parametrize("fault", [stale, half, altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    res = run_small(small_cell(name), wrap=fault)
    assert not res["correct"], res["checks"]


# ---- imports ----------------------------------------------------------------

def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_and_the_work_model_import_nothing_of_the_program():
    """Neither the yardstick (reference, work model, scenes, traffic kinds)
    nor anything else of the benchmark imports JAX or the JAX package."""
    pkg = ROOT / "portbench"
    for sub in ("reference", "work", "scenes", "kinds"):
        for f in (pkg / sub).rglob("*.py"):
            assert not _imports(f) & {"bvh_tpu_torch", "bvh_tpu", "jax"}, f
    for f in pkg.rglob("*.py"):
        assert not _imports(f) & {"jax", "jaxlib", "flax", "bvh_tpu"}, f


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time; sys.path.insert(0, sys.argv[1])\n"
        "from portbench import harness\n"
        "from portbench.tests.test_portbench_harness import small_cell\n"
        "harness.run_cell(small_cell('cubes120k.nearest'), 1, 0.1, False, "
        "'cpu', time.perf_counter())\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
