"""Runs one cell of the port's benchmark once, on the card, and prints one
JSON line as the last line of standard output.

    python3 portbench/run.py --workload cubes120k.aimed --seed 7 \
        --seconds 10 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled stretch. Every run checks a sample of
the window's answers against the plain reference and prints each number
compared beside its limit, last on standard error and under ``checks`` in
the result. Exits nonzero without a result when no card (or too few) is
present, when the program is not in the checkout, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program builds its kernels into bvh_tpu_torch/_build/ inside the
    # checkout, and the work model caches under portbench/_cache/
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if importlib.util.find_spec("bvh_tpu_torch") is None:
        print("portbench: the program (bvh_tpu_torch) is not in this "
              "checkout", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    res["device"]["nvidia_smi"] = _power_limit()
    for k, v in res["checks"].items():  # the result's last key
        value = "non-finite" if v["value"] is None else v["value"]
        print(f"check {k} {value} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
