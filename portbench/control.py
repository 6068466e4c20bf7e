"""The readings a cell's limits are set from, on the card, at the cell's own
size: the compared numbers of the program over many seeds, and of the
control over a few. The control is the plain reference computed in
bfloat16, the precision below the configuration's float32, in the
program's place. With ``--counts``, the work model's tests per ray or
point beside the program's counting builds' on the same sample.

    python3 portbench/control.py --workload cubes120k.aimed \
        --seeds 1-12 --control-seeds 1-3 [--counts]

The program answers every batch of a seed's pool once (the timed call);
the check's sample is drawn as a run draws it. Prints one JSON line per
reading. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _seeds(spec: str) -> list:
    lo, _, hi = spec.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def program_counts(scene, rows, points: bool) -> dict:
    """The program's counting builds on ``rows``: slab or box tests and
    triangle tests per ray or point, in the model's units (a group test is
    16 box tests, a leaf fire ``W`` triangle tests)."""
    from bvh_tpu_torch.ops import nearest as near_mod
    from bvh_tpu_torch.ops import trace as trace_mod
    from bvh_tpu_torch.ray import Ray
    n, w = rows[0].shape[0], int(scene.width)
    if points:
        steps, fires = near_mod.count_visits_nearest(scene, rows[0])
        return {"box": float(steps.sum()) * 16 / n,
                "prim": float(fires.sum()) * w / n}
    _, fires, tests = trace_mod.count_visits_wide(scene, Ray.create(*rows))
    return {"box": float(tests.sum()) * 16 / n,
            "prim": float(fires.sum()) * w / n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    ap.add_argument("--counts", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, traffic
    from portbench.work import model

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    mix, entry = cell.traffic, cell.entry
    points = entry.WORK == "points"
    tris_np, tris, scene, call = harness.build(cell, dev)
    ctl_seeds = set(_seeds(args.control_seeds))
    for seed in sorted(set(_seeds(args.seeds)) | ctl_seeds):
        pool, labels = traffic.make_pool(mix, tris, seed, dev, entry.INPUTS)
        kept = {slot: call(b) for slot, b in enumerate(pool)}
        torch.cuda.synchronize()
        rows, outs = harness.check_sample(pool, labels, kept, seed,
                                          int(mix["check"]["per_slot"]), dev)
        del kept
        print(json.dumps({"cell": cell.name, "reading": "program",
                          "seed": seed,
                          **entry.numbers(rows, outs, tris)}),
              flush=True)
        if seed in ctl_seeds:
            ctl = entry.reference(rows, tris, dtype=torch.bfloat16)
            print(json.dumps({"cell": cell.name, "reading": "control",
                              "seed": seed,
                              **entry.numbers(rows, ctl, tris)}),
                  flush=True)
        if args.counts and seed == min(ctl_seeds):
            sample = harness.work_sample(pool, seed, dev)
            cache = ROOT / "portbench" / "_cache" / "work"
            tree = model.tree(tris_np, cache)
            mine = model.counts(tree, tris, sample, points, cache,
                                (cell.name, seed, model.SAMPLE))
            print(json.dumps({"cell": cell.name, "reading": "counts",
                              "seed": seed, "model": mine,
                              "program": program_counts(scene, sample,
                                                        points)}),
                  flush=True)
        del pool, labels
    return 0


if __name__ == "__main__":
    sys.exit(main())
