"""CPU tests of the port's benchmark: every name resolves to its files, a
cell is added by files and entries alone, each mix runs end to end at a
tiny size against the reference, the control and the planted faults come
out not correct, and nothing loads JAX or the JAX package.

Run: ``python -m pytest portbench/tests -q`` from the repository root.
"""

from __future__ import annotations

import ast
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import harness, plugin, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# tiny scenes for the CPU: 600 triangles of cubes
SMALL_SCENE = {"create_n_cubes": {"n": 50, "seed": 0}}


def small_cell(name: str, root: Path = ROOT) -> harness.Cell:
    """The cell at a size the CPU runs in a second: a tiny scene, batches of
    1,024 rays or points, two of them, 128 checked a batch; a second part's
    share raised to 1/8 so that its stratum holds enough rays to check."""
    c = harness.load_cell(name, root)
    c.config["scene"]["args"] = SMALL_SCENE[c.config["scene"]["maker"]]
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
        assert callable(plugin(ROOT, "scenes", data["scene"]["maker"]).make)
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


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A new traffic kind, mix, entry kind and cell, each a new file, and
    entries in BENCHMARK.json: no file that is there changes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    pkg = tmp_path / "portbench"
    before = _tree_hashes(pkg)
    (pkg / "kinds/far_centroids.py").write_text(FAR_KIND)
    (pkg / "entries/tracer_halves.py").write_text(HALVES_ENTRY)
    mix = json.loads((pkg / "traffic/aimed.json").read_text())
    mix["parts"] = [{"kind": "far_centroids", "share": 1.0, "spread": 60.0}]
    mix["entry"]["kind"] = "tracer_halves"
    (pkg / "traffic/far.json").write_text(json.dumps(mix))
    # far rays: the limits of the cell whose check holds far rays
    shutil.copy(pkg / "cells/cubes120k.random.json",
                pkg / "cells/cubes120k.far.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "cubes120k.far",
                               "config": "cubes120k", "traffic": "far",
                               "chips": 1, "why": "far rays, halved"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cubes120k.aimed" in m.get("workloads", []):
            m["workloads"].append("cubes120k.far")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = small_cell("cubes120k.far", tmp_path)
    assert cell.entry.__file__ == str(pkg / "entries/tracer_halves.py")
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"rays_per_s", "batch_ms_p95", "setup_s"}
    assert res["checks"]["flips"]["value"] == 0.0
    res = run_small(cell, wrap=half)
    assert not res["correct"], res["checks"]
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
