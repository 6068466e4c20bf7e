"""Nearest-triangle point queries: the reference's ``nearest_to`` workflow
on the port (twin of ``examples/nearest_query.py``).

Builds a scene, sends a batch of query points through the kernel path
(``ops.nearest_tight``: the group walk where the scene has a wide table,
else the entry/exit walk, each with its point-triangle leaf test), checks a
sample against brute force, and then answers the same sample through the
general path (``bvh.build_sah`` + ``bvh.nearest_to_triangles``: any D,
float32 or float64, PyTorch operations).

Reference analogs: ``FlatBvh::nearest_to`` (src/flat_bvh.rs:513-562) and
``Bvh::nearest_to`` (src/bvh/bvh_impl.rs:221-238).

Run: python -m bvh_tpu_torch.examples.nearest_query [--cubes 1000]
     [--points 65536] [--radius R] [--cpu]
(``--cpu``: the plain PyTorch path on the CPU, at most 150 cubes and 4,096
points.)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import testbase as tb
from ..bvh import build_sah, nearest_to_triangles
from ..ops import build_tight_scene, nearest_tight
from ..tri import point_triangle_distance_squared
from ._common import pick_device, sync, timed

N_CHECK = 256  # points checked against brute force and the general path


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cubes", type=int, default=1000)
    ap.add_argument("--points", type=int, default=1 << 16)
    ap.add_argument("--radius", type=float, default=None,
                    help="optional search radius (d_max)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU (small sizes)")
    args = ap.parse_args(argv)
    if args.cpu:
        args.cubes = min(args.cubes, 150)
        args.points = min(args.points, 1 << 12)
    return args


def query_points(a, b, c, n: int) -> np.ndarray:
    """``n`` points scattered around the triangles' centroids (seed 0)."""
    rng = np.random.default_rng(0)
    cen = (a + b + c) / 3.0
    idx = rng.integers(0, len(cen), n)
    return (cen[idx] + rng.normal(scale=15.0, size=(n, 3))).astype(np.float32)


def main(argv=None) -> dict:
    args = parse(argv)
    dev = pick_device(args.cpu)
    a, b, c = tb.create_n_cubes(args.cubes)
    print(f"scene: {a.shape[0]} triangles")

    scene, dt_build = timed(lambda: build_tight_scene(a, b, c), dev)
    wide = scene.gnodes is not None
    print(f"build: {dt_build * 1e3:.0f} ms "
          f"(W={scene.width}, wide={'yes' if wide else 'no'})")

    pts = torch.from_numpy(query_points(a, b, c, args.points)).to(dev)

    def run():
        return nearest_tight(scene, pts, packet=2048, d_max=args.radius,
                             device=dev)

    run()  # builds the kernels on first use, warms up
    sync(dev)
    (sid, dist), dt = timed(run, dev)
    sid, dist = sid.cpu().numpy(), dist.cpu().numpy()
    found = sid >= 0
    mean_d = float(dist[found].mean()) if found.any() else float("nan")
    rate = args.points / dt
    print(f"kernel nearest: {args.points} points in {dt * 1e3:.0f} ms "
          f"({rate / 1e6:.2f} M queries/s on {dev.type}), "
          f"{int(found.sum())} found, mean distance {mean_d:.3f}")

    # a sample against brute force over every triangle
    k = min(N_CHECK, args.points)
    A, B, C = (torch.from_numpy(x).to(dev) for x in (a, b, c))
    d2 = point_triangle_distance_squared(pts[:k, None, :], A[None], B[None],
                                         C[None])
    bd_all = torch.sqrt(d2.amin(dim=1)).cpu().numpy()
    bd = bd_all
    if args.radius is not None:
        bd = np.where(bd < args.radius, bd, np.inf)
    fin = np.isfinite(bd)
    brute_ok = bool(np.allclose(np.where(fin, dist[:k], 0),
                                np.where(fin, bd, 0), rtol=1e-4, atol=1e-2)
                    and (np.isfinite(dist[:k]) == fin).all())
    print(f"brute-force validation on {k} points: "
          f"{'OK' if brute_ok else 'MISMATCH'}")
    assert brute_ok, "kernel nearest differs from brute force"

    # the general path: the same answers, any dtype or dimension
    mn, mx = tb.tri_aabbs(a, b, c)
    flat = build_sah(mn, mx)[0].to_device(device=dev)
    _, dist2 = nearest_to_triangles(flat, pts[:k], A, B, C)
    general_ok = bool(np.allclose(dist2.cpu().numpy(), bd_all, rtol=1e-4,
                                  atol=1e-2))
    assert general_ok, "the general path differs from brute force"
    print("general-path tier agrees")
    return {"device": str(dev), "triangles": int(a.shape[0]),
            "points": args.points, "width": int(scene.width), "wide": wide,
            "build_s": dt_build, "seconds": dt, "points_per_s": rate,
            "found": int(found.sum()), "mean_distance": mean_d,
            "checked": k, "brute_ok": brute_ok, "general_ok": general_ok}


if __name__ == "__main__":
    main()
