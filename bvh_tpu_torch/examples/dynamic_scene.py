"""A dynamic scene loop on the port: quality-preserving updates every frame
(twin of ``examples/dynamic_scene.py``).

The workflow the reference documents for ``Bvh::update_shapes``
(src/bvh/optimization.rs:304-315, README.md:192-247): build once, move a
fraction of the shapes every frame, update instead of rebuilding:

  1. build the static scene once on the host (the best SAH quality);
  2. every frame, hand the full vertex arrays and the cumulative moved set
     (padded with -1) to ``make_updater``'s update: the moved lanes are
     masked out of the static part, whose tree stays as it was, and rebuilt
     on the device into a small delta part that carries its exact cluster
     frame (``a_lo``);
  3. trace the chained (static, delta) scene; rebuild on the host only when
     the cumulative churn nears the updater's capacity.

The numpy random sequence is the original's, so every frame moves the same
triangles by the same shifts. At the end the hit mask is compared with a
fresh host build's.

Run: python -m bvh_tpu_torch.examples.dynamic_scene [--cubes 1000]
     [--frames 5] [--rays 65536] [--churn 0.02] [--cpu]
(``--cpu``: the plain PyTorch path on the CPU, at most 150 cubes, 4,096
rays and 3 frames.)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import testbase as tb
from ..ops import build_tight_scene, make_updater
from ..ops.trace import trace_closest_hit_chained, trace_closest_hit_tight
from ..ray import Ray
from ._common import pick_device, timed

AGREE_MIN = 0.99  # hit masks of the updated scene against a rebuild


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cubes", type=int, default=1000)  # 12k triangles
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--rays", type=int, default=1 << 16)
    ap.add_argument("--churn", type=float, default=0.02,
                    help="fraction of triangles moved per frame")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU (small sizes)")
    args = ap.parse_args(argv)
    if args.cpu:
        args.cubes = min(args.cubes, 150)
        args.rays = min(args.rays, 1 << 12)
        args.frames = min(args.frames, 3)
    return args


def aimed_at_cubes(a: np.ndarray, n: int, rng: np.random.Generator):
    """``n`` rays from 45 units out towards cube centres, drawn from
    ``rng`` first (the original's order)."""
    centers = a.reshape(-1, 12, 3).mean(axis=1)
    idx = rng.integers(0, len(centers), n)
    offs = rng.normal(size=(n, 3)).astype(np.float32)
    offs /= np.linalg.norm(offs, axis=1, keepdims=True)
    o = (centers[idx] + offs * 45.0).astype(np.float32)
    d = (centers[idx] + 0.1 - o).astype(np.float32)
    return o, d


def frame_moves(rng: np.random.Generator, n: int, per_frame: int):
    """One frame's moved triangles and their shift, drawn from ``rng``."""
    mv = rng.choice(n, size=per_frame, replace=False).astype(np.int32)
    shift = rng.uniform(5, 25, size=(1, 3)).astype(np.float32)
    return mv, shift


def main(argv=None) -> dict:
    """Returns the printed numbers, the checks, and under ``outputs`` the
    rays, the last frame's hit distances, the moved vertices and the
    cumulative moved set (numpy) for a caller's own checks."""
    args = parse(argv)
    dev = pick_device(args.cpu)
    a, b, c = tb.create_n_cubes(args.cubes)
    n = a.shape[0]
    per_frame = max(int(n * args.churn), 12)
    cap = per_frame * args.frames  # cumulative capacity before a rebuild

    scene, dt_build = timed(lambda: build_tight_scene(a, b, c), dev)
    print(f"host build: {n} tris in {dt_build:.3f}s")
    updater = make_updater(scene, max_moved=cap, device=dev)

    rng = np.random.default_rng(0)
    o, d = aimed_at_cubes(a, args.rays, rng)
    rays = Ray.create(o, d, device=dev)

    moved_all = np.full(cap, -1, np.int32)
    n_moved = 0
    a2, b2, c2 = a.copy(), b.copy(), c.copy()
    frames = []
    for frame in range(args.frames):
        # move per_frame random triangles by one shift (the reference's
        # randomly_transform_scene moves whole cubes)
        mv, shift = frame_moves(rng, n, per_frame)
        for arr in (a2, b2, c2):
            arr[mv] += shift
        moved_all[n_moved:n_moved + per_frame] = mv
        n_moved += per_frame

        def step():
            chained = updater(*(torch.from_numpy(x).to(dev)
                                for x in (a2, b2, c2, moved_all)))
            return trace_closest_hit_chained(chained, rays, packet=1024,
                                             device=dev)

        hit, dt = timed(step, dev)
        n_hits = int(torch.isfinite(hit.t).sum())
        label = "first call (kernel builds)" if frame == 0 else "run"
        print(f"frame {frame}: moved {n_moved}/{cap} cumulative, "
              f"{n_hits}/{args.rays} hits, {label} {dt:.3f}s")
        frames.append({"moved": n_moved, "hits": n_hits, "seconds": dt})

    # the last frame against a fresh host build
    rebuilt = build_tight_scene(a2, b2, c2)
    want = trace_closest_hit_tight(rebuilt, rays, packet=1024, device=dev)
    tg, tw = hit.t.cpu().numpy(), want.t.cpu().numpy()
    agree = float((np.isfinite(tg) == np.isfinite(tw)).mean())
    print(f"updated-vs-rebuilt hit masks agree: {agree:.4f}")
    assert agree > AGREE_MIN, f"updated and rebuilt hit masks agree {agree}"
    return {"device": str(dev), "triangles": n, "rays": args.rays,
            "per_frame": per_frame, "capacity": cap, "build_s": dt_build,
            "frames": frames, "agree": agree,
            "outputs": {"o": o, "d": d, "t": tg, "tris": (a2, b2, c2),
                        "moved": moved_all}}


if __name__ == "__main__":
    main()
