"""Times the port's group-walk trace kernel, its sweep gate, its entry/exit
trace kernel, its entry/exit nearest kernel and its legacy cluster walk
against an earlier checkout of the port, on one NVIDIA card, in turns (old,
new, new, old) within one process.

    python3 kernel_ab.py --old DIR [--only MODULE ...]

DIR holds an earlier checkout's ``bvh_tpu_torch`` package (for example from
``git archive <commit> bvh_tpu_torch | tar -x -C DIR``). It is imported
beside the current one under a name of its own, builds its kernels from its
own sources into its own ``_build/``, and runs through its own wrappers, so
an earlier C interface needs no adapter here. Both packages are called at
points whose signatures the two share: ``ops.trace._walk`` (the group walk,
its gate passed in, no sweep; the entry/exit walk with ``wide=False``),
``ops.sweep.sweep_gate`` over the package's own device copy of the node
table (``ops.trace._dev`` with the package's ``node_records`` where it has
one), ``ops.nearest.nearest_wide`` and ``nearest_entry_exit``, and
``ops.trace.trace_closest_hit``
(the legacy walk with the ray rows before it and the hit record after it).
``--only`` limits the runs to one module's kernel (``wide_trace``,
``sweep``, ``tight_trace``, ``nearest``, ``cluster_trace``, ``epilogue``,
``order``)
or to the trace walks' FRAME builds (``frame``), so that a copy
of the package with one source changed can be timed against the current
one.
The scenes are built once, by the current package, and the rows are the
ones ``chip_smoke.py`` gives the kernels (built by its helpers):

* the group walk (W=16, 120k-triangle scene) on the 2,097,152 random rays
  sorted octmorton, on the 1,048,576 aimed rays sorted morton and gated by
  the sweep at packet 8192, on the dense mesh's 1024x1024 camera (W=128),
  and on the path tracer's first bounce wave (unsorted, gated) and first
  shadow wave (``mode="any"``, gated), as one frame launches them;
* the sweep gate (packet 8192) on the random rays sorted octmorton over
  ``smem_nodes``, on the aimed rays sorted morton over ``smem_nodes`` and
  over a packed=True build's ``packed_nodes``, and on the first part of
  ``chip_smoke.py``'s ``chained_aimed`` leg (1,008,000 triangles in 11
  parts), with the rows carrying that part's bound and its root pre-gate,
  as the chained trace launches it;
* the entry/exit walk on the aimed rays over a wide=False build and a
  packed=True build, each gated by its sweep at packet 8192, and the any-hit
  rows of ``shadow_aimed_entry_exit`` (t_max 1.2x each ray's hit);
* both nearest walks (group and entry/exit) on the 1,048,576 sorted random
  points, and ``ops.nearest.nearest_tight`` end to end (sort, walk, id
  map, un-permute) in both walks on the same points unsorted, as
  ``chip_smoke.py``'s nearest legs call it;
* the legacy walk on the 2,097,152 random rays and the 1,048,576 aimed
  rays, each sorted with ``sort_rays``, on the ``ClusterScene``;
* ``frame``: the FRAME builds of the group walk (a grid device build of the
  120k scene) and of the entry/exit walk (an LBVH device build) on the
  aimed rows, on ``far_aimed_rays`` (1,048,576, seed 17, morton) and on
  the shared-edge case (``chip_smoke.shared_edge_case``, unsorted).

* ``epilogue``: the whole closest-hit call of both packages at the two
  shapes the benchmark's cells give the epilogue: ``make_tracer(packet=8192,
  sort="morton", tris)`` on the aimed rays (the cell ``cubes120k.aimed``),
  and ``trace_closest_hit_tight(tris, packet=1024)`` of a path-traced
  frame's primary wave, 1,048,576 camera rays over SPD ``tetra`` at size
  factor 8 (the cell ``spd_tetra8.path``; the scene and the rays from
  ``portbench/``).

* ``order``: the whole closest-hit call of both packages on the two cells'
  rays and sorts, ``make_tracer(packet=8192, sort="morton", tris)`` on the
  aimed rays (``cubes120k.aimed``) and ``make_tracer(packet=8192,
  sweep=False, sort="octmorton")`` on the random rays
  (``cubes120k.random``).

The current package's bound seed (``ops.nearest.nearest_seed``) is held
against its plain version on the sorted random points, bit for bit, and
timed there (``held``); so is its epilogue kernel against its plain
composition (``ops.trace._epilogue_plain``) on the walk's answers at the
two ``epilogue`` shapes (``chip_smoke.epilogue_leg``: device ms a call
over calls replayed as one CUDA graph, the inputs cold in L2 and warm,
beside the kernel's bound, the bytes it cannot avoid at the HBM peak), and
its order kernels (``ops/order.py``: the key and the rows) against their
plain composition on the aimed and random rays (``chip_smoke.order_leg``,
timed the same way).

Each time is ``chip_smoke.cuda_ms``. Old and new results are compared bit
for bit: the gates and the group, entry/exit and nearest walks must agree
(``nearest_tight`` end to end in its distances, its ids but where two
triangles lie equally near, since one package may seed the walks' bound);
the legacy walks may differ where the two form the leaf test in other
ways (the float64 tv and w against the float32 ones), and the FRAME builds
where the two form the leaf test in other precisions; the count is
reported. The scenes are the current package's, so both packages' walks
take whatever exact-frame table a scene carries. Prints the card's name
and power limit, then one JSON line.
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
from bvh_tpu_torch.ops import (build_chained_scene, build_cluster_scene,
                               build_tight_scene, build_tight_scene_device,
                               make_tracer, sort_rays_device,
                               trace_closest_hit_chained)
from bvh_tpu_torch.ops import nearest as near_mod
from bvh_tpu_torch.ops import sweep as sweep_mod
from bvh_tpu_torch.ops import trace as trace_mod
from bvh_tpu_torch.ops.trace import _dev, _ray_rows

MODULES = ("wide_trace", "sweep", "tight_trace", "nearest", "cluster_trace",
           "frame", "epilogue", "order")
ROOT = Path(__file__).resolve().parent


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
                 for m in ("trace", "nearest", "sweep")}
           for tag, pkg in (("old", "kernel_ab_old"), ("new", "bvh_tpu_torch"))}
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    cs.check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    run_set, held = runs(dev, names)
    out = compare(run_set, ops)
    print(json.dumps({"card": card, "reps": cs.REPS, "runs": out,
                      "held": held}), flush=True)


def wide_run(scene, rows, gate=None, packet=8192, bounded=False,
             mode="closest", hints=None):
    """A group-walk run: ``_walk`` of either package over ``scene``."""
    return lambda ops: ops["trace"]._walk(scene, rows, packet, False, bounded,
                                          mode, True, hints, pre_gate=gate)


def tight_run(scene, rows, gate=None, packet=8192, bounded=False,
              mode="closest"):
    """An entry/exit-walk run: ``_walk`` of either package over ``scene``
    with ``wide=False``."""
    return lambda ops: ops["trace"]._walk(scene, rows, packet, False, bounded,
                                          mode, False, pre_gate=gate)


def sweep_run(table, rows, packet=8192, packed=False, pre_gate=None):
    """A sweep run: either package's ``sweep_gate`` over its own device copy
    of the host ``table`` (in its ``node_records`` layout where it has
    one)."""
    def run(ops):
        layout = getattr(ops["sweep"], "node_records", None)
        nodes = ops["trace"]._dev(table, rows.device, layout)
        return (ops["sweep"].sweep_gate(nodes, rows, packet, packed=packed,
                                        pre_gate=pre_gate),)
    return run


def seed_hold(scene, rows) -> dict:
    """The current package's bound seed against its plain version on
    ``rows`` (bit for bit, the seeded rows and the group tests), and both
    timed there."""
    gn = _dev(scene.gnodes, rows.device)
    differ, seeded = cs.seed_compare(scene, rows)
    cs.check(differ == 0, f"nearest_seed: {differ} points differ from plain")
    work = rows.clone()
    return {"rows": int(rows.shape[1]), "rows_differ": differ,
            "seeded_below": int((seeded[3] < rows[3]).sum()),
            "ms": cs.cuda_ms(lambda: near_mod.nearest_seed(gn, work)),
            "plain_ms": cs.cuda_ms(lambda: near_mod.nearest_seed_plain(
                gn, work), reps=3, warmup=0)}


def path_primary(dev):
    """The cell ``spd_tetra8.path``'s scene, its [n, 9] vertex table on
    ``dev`` and a frame's 1,048,576 camera rays (seed 7), from
    ``portbench/``."""
    from portbench import plugin
    tris_np = plugin(ROOT, "scenes", "spd_tetra").make(8)
    o, d, _ = plugin(ROOT, "kinds", "camera").make(
        1 << 20, torch.Generator(device=dev).manual_seed(7),
        {"scene": "spd_tetra", "tile": 32, "bounces": 2},
        {"device": dev, "tris": None})
    v9 = torch.cat([torch.from_numpy(x) for x in tris_np], dim=1).to(dev)
    return build_tight_scene(*tris_np), v9, o, d


def runs(dev, names) -> tuple:
    """The runs of the modules ``names``: {key: (module name, launch[,
    allowed])}, where launch(ops) runs the row set through one package's
    modules and allowed(old, new), where given, tells whether results that
    differ are still right; and what was held in the current package alone
    (the bound seed, which the earlier package may not have)."""
    a, b, c = tb.create_n_cubes(10000)
    o, d, ao, ad = cs.main_rays(a)
    scene = build_tight_scene(a, b, c)
    dense = tb.create_dense_mesh()
    out, wide, held = {}, {}, {}
    if "wide_trace" in names:
        scene_d = build_tight_scene(*dense, leaf_size=128)
        o_dev, d_dev, ao_dev, ad_dev = (torch.from_numpy(x).to(dev)
                                        for x in (o, d, ao, ad))
        oc, dc = (torch.from_numpy(x).to(dev) for x in cs.dense_camera())
        wide["random"] = wide_run(
            scene, cs.trace_rows(o_dev, d_dev, "octmorton"))
        rows_a = cs.trace_rows(ao_dev, ad_dev, "morton")
        gate = sweep_mod.sweep_gate(cs.node_recs(scene.smem_nodes, dev),
                                    rows_a, 8192)
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
    if "sweep" in names or "tight_trace" in names:
        scene_nw = build_tight_scene(a, b, c, wide=False)
        scene_pk = build_tight_scene(a, b, c, packed=True)
        o_dev, d_dev, ao_dev, ad_dev = (torch.from_numpy(x).to(dev)
                                        for x in (o, d, ao, ad))
        rows_r = cs.trace_rows(o_dev, d_dev, "octmorton")
        rows_a = cs.trace_rows(ao_dev, ad_dev, "morton")
        gates = {sc: sweep_mod.sweep_gate(
                     cs.node_recs(tab, dev), rows_a, 8192, packed=packed)
                 for sc, tab, packed in (
                     ("nw", scene_nw.smem_nodes, False),
                     ("pk", scene_pk.packed_nodes, True))}
    if "sweep" in names:
        out["sweep/random"] = ("sweep", sweep_run(scene.smem_nodes, rows_r))
        out["sweep/aimed"] = ("sweep", sweep_run(scene.smem_nodes, rows_a))
        out["sweep/aimed_packed"] = ("sweep", sweep_run(
            scene_pk.packed_nodes, rows_a, packed=True))
        # the first part of the chained aimed leg, as the chain launches it
        cubes = tb.create_n_cubes(84000)
        ch = build_chained_scene(*cubes, max_part=100_000)
        co, cd = (torch.from_numpy(x).to(dev)
                  for x in tb.aimed_rays(cubes[0], 1 << 20))
        perm, _ = sort_rays_device(co, cd, mode="morton")
        _, calls = cs.recorded(lambda: trace_closest_hit_chained(
            ch, Ray.create(co, cd), tris=tuple(torch.from_numpy(x).to(dev)
                                               for x in cubes),
            packet=8192, perm=perm), targets=((trace_mod, "sweep_gate"),))
        args, kw, _ = calls["sweep_gate"][0]
        cs.check(ch.parts[0].sweep_nodes is None
                 and ch.parts[0].packed_nodes is None, "chain part tables")
        out["sweep/chained_aimed_part0"] = ("sweep", sweep_run(
            ch.parts[0].smem_nodes, args[1], packet=args[2],
            pre_gate=kw["pre_gate"]))
    if "tight_trace" in names:
        out["tight_trace/aimed_gated"] = ("tight_trace", tight_run(
            scene_nw, rows_a, gate=gates["nw"]))
        out["tight_trace/aimed_packed_gated"] = ("tight_trace", tight_run(
            scene_pk, rows_a, gate=gates["pk"]))
        # shadow_aimed_entry_exit: any hit below 1.2x each ray's hit
        h = make_tracer(scene, packet=8192, sort="morton", tris=(a, b, c),
                        device=dev)(ao_dev, ad_dev)
        perm, _ = sort_rays_device(ao_dev, ad_dev, mode="morton")
        rows_sh = _ray_rows(Ray.create(ao_dev, ad_dev).take(perm),
                            (h.t * 1.2)[perm])
        out["tight_trace/shadow_aimed_any"] = ("tight_trace", tight_run(
            scene_nw, rows_sh, bounded=True, mode="any"))
    if "nearest" in names:
        rows_p, _ = cs.nearest_rows(*cs.nearest_points(dense, dev))
        sn, grp = _dev(scene.smem_nodes, dev), _dev(scene.groups, dev)
        gn = _dev(scene.gnodes, dev)
        out["nearest_wide/random"] = ("nearest", lambda ops: ops[
            "nearest"].nearest_wide(gn, grp, rows_p, scene.width,
                                    scene.gdepth))
        out["nearest_tight/random"] = ("nearest", lambda ops: ops[
            "nearest"].nearest_entry_exit(sn, grp, rows_p, scene.width))
        held["nearest_seed/random"] = seed_hold(scene, rows_p)
        pts, _ = cs.nearest_points(dense, dev)
        tris_dev = tuple(torch.from_numpy(x).to(dev) for x in (a, b, c))

        def ties(old, new):
            """Distances bit-equal, and ids apart only in the tie class: a
            package that seeds the walks' bound may keep the other of two
            equally near triangles."""
            (so, do), (sn, dn) = old, new
            diff = so != sn
            return (torch.equal(do.view(torch.int32), dn.view(torch.int32))
                    and (not bool(diff.any()) or cs.ties_only(
                        pts[diff], so[diff], do[diff], sn[diff], dn[diff],
                        tris_dev)))
        for key, wide in (("random", None), ("random_entry_exit", False)):
            out[f"nearest_e2e/{key}"] = ("nearest", lambda ops, wide=wide: ops[
                "nearest"].nearest_tight(scene, pts, wide=wide), ties)
    if "frame" in names:
        tris_dev = tuple(torch.from_numpy(x).to(dev) for x in (a, b, c))
        grid = build_tight_scene_device(*tris_dev)
        lbvh = build_tight_scene_device(*tris_dev, upper="lbvh")
        edge = cs.shared_edge_case(dev)
        rows = {"aimed": cs.trace_rows(*(torch.from_numpy(x).to(dev)
                                         for x in (ao, ad)), "morton"),
                "far": cs.trace_rows(*(torch.from_numpy(x).to(dev) for x in
                                       cs.far_aimed_rays(a, b, c, 1 << 20,
                                                         seed=17)), "morton"),
                "shared_edges": cs.trace_rows(*edge["rays"], None)}
        for key, r in rows.items():
            sc_w, sc_t = ((edge["scene"], edge["scene"]) if key ==
                          "shared_edges" else (grid, lbvh))
            out[f"frame/wide_{key}"] = ("frame", wide_run(sc_w, r))
            out[f"frame/tight_{key}"] = ("frame", tight_run(sc_t, r))
    if "epilogue" in names:
        ao_dev, ad_dev = (torch.from_numpy(x).to(dev) for x in (ao, ad))
        tris9 = torch.cat([torch.from_numpy(x) for x in (a, b, c)],
                          dim=1).to(dev)
        held["epilogue/aimed"] = cs.epilogue_leg(scene, ao_dev, ad_dev,
                                                 "morton", 8192, True, tris9)
        tracers = {}

        def aimed_call(ops):
            key = ops["trace"].__name__
            if key not in tracers:
                tracers[key] = ops["trace"].make_tracer(
                    scene, packet=8192, sort="morton", tris=(a, b, c),
                    device=dev)
            return tuple(tracers[key](ao_dev, ad_dev))
        out["epilogue/aimed_tracer"] = ("epilogue", aimed_call)
        scene_p, v9, po, pd = path_primary(dev)
        held["epilogue/path_primary"] = cs.epilogue_leg(scene_p, po, pd, None,
                                                        1024, False, v9)
        rays_p = Ray.create(po, pd)
        views = v9.split(3, dim=1)
        out["epilogue/path_primary"] = ("epilogue", lambda ops: tuple(
            ops["trace"].trace_closest_hit_tight(scene_p, rays_p, tris=views,
                                                 packet=1024)))
    if "order" in names:
        o_dev, d_dev, ao_dev, ad_dev = (torch.from_numpy(x).to(dev)
                                        for x in (o, d, ao, ad))
        held["order/aimed"] = cs.order_leg(ao_dev, ad_dev, "morton")
        held["order/random"] = cs.order_leg(o_dev, d_dev, "octmorton")
        order_tracers = {}

        def tracer_call(ops, leg):
            key = (ops["trace"].__name__, leg)
            if key not in order_tracers:
                make = ops["trace"].make_tracer
                order_tracers[key] = (
                    make(scene, packet=8192, sort="morton", tris=(a, b, c),
                         device=dev) if leg == "aimed"
                    else make(scene, packet=8192, sweep=False,
                              sort="octmorton", device=dev))
            rays = (ao_dev, ad_dev) if leg == "aimed" else (o_dev, d_dev)
            return tuple(order_tracers[key](*rays))
        for leg in ("aimed", "random"):
            out[f"order/{leg}_tracer"] = (
                "order", lambda ops, leg=leg: tracer_call(ops, leg))
    if "cluster_trace" in names:
        legacy = build_cluster_scene(a, b, c)
        for key, (lo, ld) in (("legacy_random", (o, d)),
                              ("legacy_aimed", (ao, ad))):
            rays = Ray.create(*cs.sort_legacy(lo, ld, dev)[1], device=dev)

            def legacy_run(ops, rays=rays):
                hit = ops["trace"].trace_closest_hit(legacy, rays, device=dev)
                return hit.t, hit.shape_id
            out[f"cluster_trace/{key}"] = ("cluster_trace", legacy_run)
    return out, held


def rows_differ(a: tuple, b: tuple) -> int:
    """Rows (rays, points or packets) whose outputs differ in any bit."""
    bad = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        bad |= ((x.view(torch.int32) != y.view(torch.int32))
                if x.is_floating_point() else x != y)
    return int(bad.sum())


def compare(run_set: dict, ops: dict) -> dict:
    """Old against new on every run: rows (rays, points or packets), rows
    whose results differ, hits (open gates for the sweep), the old and the
    new times (ms) and the speedup."""
    out = {}
    for key, (name, fn, *allowed) in run_set.items():
        res = {tag: fn(ops[tag]) for tag in ("old", "new")}
        torch.cuda.synchronize()
        differ = rows_differ(res["old"], res["new"])
        if name not in ("cluster_trace", "frame"):
            cs.check(differ == 0 or (allowed and allowed[0](res["old"],
                                                            res["new"])),
                     f"{key}: old and new differ on {differ} rows")
        ms = {"old": [], "new": []}
        for tag in ("old", "new", "new", "old"):
            ms[tag].append(cs.cuda_ms(lambda: fn(ops[tag])))
        new = res["new"]
        out[key] = {"rows": int(new[0].shape[0]), "rows_differ": differ,
                    "hits": int((new[0] != 0).sum() if len(new) == 1
                                else (new[1] >= 0).sum()),
                    "old_ms": ms["old"], "new_ms": ms["new"],
                    "speedup": sum(ms["old"]) / sum(ms["new"])}
    return out


if __name__ == "__main__":
    main()
