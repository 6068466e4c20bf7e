"""Times the port's group-walk trace kernel, its entry/exit nearest kernel
and its legacy cluster walk against an earlier checkout of the port, on one
NVIDIA card, in turns (old, new, new, old) within one process.

    python3 kernel_ab.py --old DIR [--only MODULE ...]

DIR holds an earlier checkout's ``bvh_tpu_torch`` package (for example from
``git archive <commit> bvh_tpu_torch | tar -x -C DIR``). It is imported
beside the current one under a name of its own, builds its kernels from its
own sources into its own ``_build/``, and runs through its own wrappers, so
an earlier C interface needs no adapter here. Both packages are called at
points whose signatures the two share: ``ops.trace._walk`` (the group walk,
its gate passed in, no sweep), ``ops.nearest.nearest_entry_exit`` and
``ops.trace.trace_closest_hit`` (the legacy walk with the ray rows before
it and the hit record after it). ``--only`` limits the runs to one module's
kernel (``wide_trace``, ``nearest``, ``cluster_trace``), so that a copy of
the package with one source changed can be timed against the current one.
The scenes are built once, by the current package, and the rows are the
ones ``chip_smoke.py`` gives the kernels (built by its helpers):

* the group walk (W=16, 120k-triangle scene) on the 2,097,152 random rays
  sorted octmorton, on the 1,048,576 aimed rays sorted morton and gated by
  the sweep at packet 8192, on the dense mesh's 1024x1024 camera (W=128),
  and on the path tracer's first bounce wave (unsorted, gated) and first
  shadow wave (``mode="any"``, gated), as one frame launches them;
* the entry/exit nearest walk on the 1,048,576 sorted random points;
* the legacy walk on the 1,048,576 aimed rays, sorted, on the
  ``ClusterScene``.

Each time is ``chip_smoke.cuda_ms``. Old and new results are compared bit
for bit: the group and nearest walks must agree; the legacy walks may
differ where one subtracts the table's ``a_lo`` and the other does not, and
the count is reported. Prints the card's name and power limit, then one
JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from bvh_tpu_torch import Ray
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import build_cluster_scene, build_tight_scene
from bvh_tpu_torch.ops import sweep as sweep_mod
from bvh_tpu_torch.ops import trace as trace_mod
from bvh_tpu_torch.ops.trace import _dev

MODULES = ("wide_trace", "nearest", "cluster_trace")


def import_package(root: Path, name: str):
    """The ``bvh_tpu_torch`` package under ``root`` imported as ``name``
    (its modules import one another relatively)."""
    init = root / "bvh_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory holding an earlier bvh_tpu_torch package")
    ap.add_argument("--only", choices=MODULES, action="append",
                    help="compare only this module's kernel (repeatable)")
    args = ap.parse_args()
    names = args.only or list(MODULES)
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available; this script needs an NVIDIA "
              "GPU", file=sys.stderr)
        sys.exit(2)
    cs.check((args.old / "bvh_tpu_torch" / "__init__.py").is_file(),
             f"{args.old} holds no bvh_tpu_torch package")
    import_package(args.old, "kernel_ab_old")
    ops = {tag: {m: importlib.import_module(f"{pkg}.ops.{m}")
                 for m in ("trace", "nearest")}
           for tag, pkg in (("old", "kernel_ab_old"), ("new", "bvh_tpu_torch"))}
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    cs.check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = compare(runs(dev, names), ops)
    print(json.dumps({"card": card, "reps": cs.REPS, "runs": out}),
          flush=True)


def wide_run(scene, rows, gate=None, packet=8192, bounded=False,
             mode="closest", hints=None):
    """A group-walk run: ``_walk`` of either package over ``scene``."""
    return lambda ops: ops["trace"]._walk(scene, rows, packet, False, bounded,
                                          mode, True, hints, pre_gate=gate)


def runs(dev, names) -> dict:
    """The runs of the modules ``names``: {key: (module name, launch)},
    where launch(ops) runs the row set through one package's modules."""
    a, b, c = tb.create_n_cubes(10000)
    o, d, ao, ad = cs.main_rays(a)
    scene = build_tight_scene(a, b, c)
    dense = tb.create_dense_mesh()
    out, wide = {}, {}
    if "wide_trace" in names:
        scene_d = build_tight_scene(*dense, leaf_size=128)
        o_dev, d_dev, ao_dev, ad_dev = (torch.from_numpy(x).to(dev)
                                        for x in (o, d, ao, ad))
        oc, dc = (torch.from_numpy(x).to(dev) for x in cs.dense_camera())
        wide["random"] = wide_run(
            scene, cs.trace_rows(o_dev, d_dev, "octmorton"))
        rows_a = cs.trace_rows(ao_dev, ad_dev, "morton")
        gate = sweep_mod.sweep_gate(_dev(scene.smem_nodes, dev), rows_a, 8192)
        wide["aimed_gated"] = wide_run(scene, rows_a, gate=gate)
        wide["camera_w128"] = wide_run(
            scene_d, cs.trace_rows(oc, dc, None))
        # one path-tracer frame's waves: closest (primary), any (its
        # shadows), closest (the first bounce), ...
        tracer, _ = cs.pathtracer(scene_d, dense, dev)
        _, calls = cs.recorded(
            lambda: tracer(oc, dc, torch.Generator(device=dev).manual_seed(0)),
            targets=((trace_mod, "wide_trace"),))
        waves = [(args, kw) for args, kw, _ in calls["wide_trace"]]
        bounce = [w for w in waves if w[1]["mode"] != "any"][1]
        shadow = [w for w in waves if w[1]["mode"] == "any"][0]
        for key, (args, kw) in (("pathtrace_bounce", bounce),
                                ("pathtrace_shadow_any", shadow)):
            wide[key] = wide_run(
                scene_d, args[2], gate=kw["gate"], packet=kw["packet"],
                bounded=kw["bounded"], mode=kw["mode"], hints=kw["hints"])
    out.update({f"wide_trace/{k}": ("wide_trace", fn)
                for k, fn in wide.items()})
    if "nearest" in names:
        rows_p, _ = cs.nearest_rows(*cs.nearest_points(dense, dev))
        sn, grp = _dev(scene.smem_nodes, dev), _dev(scene.groups, dev)
        out["nearest_tight/random"] = ("nearest", lambda ops: ops[
            "nearest"].nearest_entry_exit(sn, grp, rows_p, scene.width))
    if "cluster_trace" in names:
        legacy = build_cluster_scene(a, b, c)
        rays = Ray.create(*cs.sort_legacy(ao, ad, dev)[1], device=dev)

        def legacy_run(ops):
            hit = ops["trace"].trace_closest_hit(legacy, rays, device=dev)
            return hit.t, hit.shape_id
        out["cluster_trace/legacy_aimed"] = ("cluster_trace", legacy_run)
    return out


def compare(run_set: dict, ops: dict) -> dict:
    """Old against new on every run: rows, rows whose results differ,
    hits, the old and the new times (ms) and the speedup."""
    out = {}
    for key, (name, fn) in run_set.items():
        res = {tag: fn(ops[tag]) for tag in ("old", "new")}
        torch.cuda.synchronize()
        differ = cs.same_bits(*res["old"], *res["new"])
        if name != "cluster_trace":
            cs.check(differ == 0, f"{key}: old and new differ on {differ} rows")
        ms = {"old": [], "new": []}
        for tag in ("old", "new", "new", "old"):
            ms[tag].append(cs.cuda_ms(lambda: fn(ops[tag])))
        out[key] = {"rows": int(res["new"][0].shape[0]), "rows_differ": differ,
                    "hits": int((res["new"][1] >= 0).sum()),
                    "old_ms": ms["old"], "new_ms": ms["new"],
                    "speedup": sum(ms["old"]) / sum(ms["new"])}
    return out


if __name__ == "__main__":
    main()
