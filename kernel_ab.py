"""Times the legacy cluster walk and the two nearest kernels of the port
against an earlier version of their CUDA sources, on one NVIDIA card, in
turns (old, new, new, old) within one process.

    python3 kernel_ab.py --old DIR

DIR holds an earlier checkout's ``bvh_tpu_torch/csrc`` (for example from
``git archive <commit> bvh_tpu_torch/csrc | tar -x -C DIR``), whose
``cluster_trace.cu`` and ``nearest.cu`` have the current C interface. The
old sources are built with the port's nvcc flags and launched through the
port's own wrappers, on the rows that ``chip_smoke.py``'s phases 7 and 10
give the kernels (built by its helpers): the 2,097,152 random and 1,048,576
aimed rays of the 120k-triangle scene on its ``ClusterScene``, its
1,048,576 random points on the W=16 tight scene (group walk and entry/exit
walk) and the dense mesh's surface points (W=128). Each time is
``chip_smoke.cuda_ms``. Old and new results are compared bit for bit: the
nearest kernels must agree; the legacy kernels may differ where the newer
one's cluster-frame origin differs, and the count is reported. Prints the
card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from bvh_tpu_torch import Ray
from bvh_tpu_torch import testbase as tb
from bvh_tpu_torch.ops import _build, build_cluster_scene, build_tight_scene
from bvh_tpu_torch.ops import cluster_trace as ct_mod
from bvh_tpu_torch.ops import nearest as near_mod

# the kernel modules compared, with their sources
MODULES = {"cluster_trace": (ct_mod, "cluster_trace.cu"),
           "nearest": (near_mod, "nearest.cu")}


def libraries(old_dir: Path) -> dict:
    """Each kernel module's old and new library, bound as the module binds
    its own."""
    cmd = [_build._nvcc()] + _build.NVCC_FLAGS
    out = {}
    for name, (mod, source) in MODULES.items():
        path = _build.build_library(f"{name}_old", [old_dir / source], cmd,
                                    headers=sorted(old_dir.glob("*.cuh")))
        out[name] = {"old": mod.bind(ctypes.CDLL(str(path))),
                     "new": mod.load()}
    return out


@contextlib.contextmanager
def launching(mod, lib):
    """Within the block, the wrappers of ``mod`` launch the kernels of
    ``lib``."""
    load = mod.load
    mod.load = lambda: lib
    try:
        yield
    finally:
        mod.load = load


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory holding an earlier bvh_tpu_torch/csrc")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available; this script needs an NVIDIA "
              "GPU", file=sys.stderr)
        sys.exit(2)
    old_dir = args.old / "bvh_tpu_torch" / "csrc"
    cs.check(old_dir.is_dir(), f"{old_dir} is not a directory")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    cs.check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = compare(libraries(old_dir), dev)
    print(json.dumps({"card": card, "reps": cs.REPS, "runs": out}),
          flush=True)


def compare(libs: dict, dev) -> dict:
    """Old against new on every run: rows, rows whose results differ,
    hits, the old and the new times (ms) and the speedup."""
    a, b, c = tb.create_n_cubes(10000)
    o, d, ao, ad = cs.main_rays(a)
    tables = cs.legacy_tables(build_cluster_scene(a, b, c), dev)
    runs = {}
    for leg, (lo, ld) in {"legacy_random": (o, d),
                          "legacy_aimed": (ao, ad)}.items():
        rows = ct_mod.ray_rows(Ray.create(*cs.sort_legacy(lo, ld, dev)[1],
                                          device=dev))
        runs[f"cluster_trace/{leg}"] = (
            "cluster_trace", lambda rows=rows: ct_mod.cluster_trace(*tables,
                                                                    rows))
    dense = tb.create_dense_mesh()
    sc, sc_d = (build_tight_scene(a, b, c),
                build_tight_scene(*dense, leaf_size=128))
    rows_r, rows_s = cs.nearest_rows(*cs.nearest_points(dense, dev))
    for key, (kind, s_, rows) in {
            "nearest_wide/random": ("wide", sc, rows_r),
            "nearest_tight/random": ("entry_exit", sc, rows_r),
            "nearest_wide/surface_w128": ("wide", sc_d, rows_s)}.items():
        runs[key] = ("nearest", lambda kind=kind, s_=s_, rows=rows:
                     cs.near_kernel(kind, s_, rows))

    out = {}
    for key, (name, fn) in runs.items():
        def run(tag, name=name, fn=fn):
            with launching(MODULES[name][0], libs[name][tag]):
                return fn()
        res = {tag: run(tag) for tag in ("old", "new")}
        torch.cuda.synchronize()
        differ = cs.same_bits(*res["old"], *res["new"])
        if name == "nearest":
            cs.check(differ == 0, f"{key}: old and new differ on {differ} rows")
        ms = {"old": [], "new": []}
        for tag in ("old", "new", "new", "old"):
            ms[tag].append(cs.cuda_ms(lambda: run(tag)))
        out[key] = {"rows": int(res["new"][0].shape[0]), "rows_differ": differ,
                    "hits": int((res["new"][1] >= 0).sum()),
                    "old_ms": ms["old"], "new_ms": ms["new"],
                    "speedup": sum(ms["old"]) / sum(ms["new"])}
    return out


if __name__ == "__main__":
    main()
