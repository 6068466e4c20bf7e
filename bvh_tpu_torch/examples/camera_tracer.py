"""Per-frame rendering with the one-call tracer (``ops.make_tracer``) on the
port (twin of ``examples/camera_tracer.py``).

``make_tracer`` copies the scene's tables to the device once and runs the
whole pipeline (sort, walk, winner, un-permute) on each call, so a render
loop pays the set-up once a scene. Two tracers are built here:

* the camera tracer (``sort=None``): the camera rays are reordered into
  32x32 tiles, already coherent, so the call sorts nothing; the depth image
  has its tile order undone and is written as a PGM;
* the free-ray tracer (``sort="octmorton"``, ``plan="key"``): an arbitrary
  batch gets the octant-major Morton sort and the key-planned subtree
  entry, and the results come back in input order; they equal the same
  tracer's without the plan bit for bit, which ``main`` checks.

Run: python -m bvh_tpu_torch.examples.camera_tracer [--cpu] [--size 256]
     [--out camera_depth.pgm] [--res 362]
(``--res``: the dense mesh's resolution, ``testbase.create_dense_mesh``'s
default 362 is 260,642 triangles.)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import testbase as tb
from ..diff.camera import camera_rays
from ..ops import build_tight_scene, make_tracer
from ._common import pick_device, sync, timed, write_pnm

EYE = (0.0, 60.0, -120.0)
LOOK_AT = (0.0, 0.0, 0.0)
UP = (0.0, 1.0, 0.0)
FOV_DEG = 55.0
N_FREE = 4096  # rays of the free-ray tracer


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default="camera_depth.pgm")
    ap.add_argument("--res", type=int, default=362,
                    help="dense mesh resolution (create_dense_mesh's res)")
    return ap.parse_args(argv)


def tile_side(size: int) -> int:
    """The tile's side: 32 where it divides the image, else 8."""
    return 32 if size % 32 == 0 else 8


def to_tiles(x: torch.Tensor, size: int) -> torch.Tensor:
    """Row-major per-pixel rows [size * size, 3] in tile-major order."""
    T = tile_side(size)
    return (x.reshape(size // T, T, size // T, T, 3).permute(0, 2, 1, 3, 4)
            .reshape(-1, 3).contiguous())


def from_tiles(x: np.ndarray, size: int) -> np.ndarray:
    """A tile-major per-pixel value [size * size] as a [size, size] image."""
    T = tile_side(size)
    return (x.reshape(size // T, size // T, T, T).transpose(0, 2, 1, 3)
            .reshape(size, size))


def camera_tiles(size: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The camera's origins and unit directions in tile-major order."""
    cam = camera_rays(np.float32(EYE), np.float32(LOOK_AT), np.float32(UP),
                      FOV_DEG, size, size, device=dev)
    return to_tiles(cam.origin, size), to_tiles(cam.direction, size)


def free_rays(a: np.ndarray, n: int = N_FREE):
    """``n`` rays from random points about the scene towards triangles'
    first vertices (seed 0)."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, a.shape[0], n)
    ro = (a[idx] + rng.normal(size=(n, 3)).astype(np.float32) * 40
          ).astype(np.float32)
    rd = (a[idx] + 0.1 - ro).astype(np.float32)
    return ro, rd


def depth_image(t: np.ndarray, size: int) -> np.ndarray:
    """The tile-major hit distances as a uint8 depth image (near is bright,
    a miss takes the farthest hit's shade)."""
    hit = np.isfinite(t)
    far = np.nanmax(np.where(hit, t, np.nan)) if hit.any() else 0.0
    img = from_tiles(np.where(hit, t, far), size)
    lo, hi = img.min(), img.max()
    return (255 * (1.0 - (img - lo) / max(hi - lo, 1e-6))).astype(np.uint8)


def main(argv=None) -> dict:
    """Returns the printed numbers, the checks, and under ``outputs`` the
    camera's tile-major rays, hit distances and shape ids (numpy) for a
    caller's own checks."""
    args = parse(argv)
    dev = pick_device(args.cpu)
    a, b, c = tb.create_dense_mesh(args.res)
    scene, dt_build = timed(lambda: build_tight_scene(a, b, c, leaf_size=128),
                            dev)
    print(f"scene: {a.shape[0]} tris, host build {1e3 * dt_build:.1f} ms")

    S = args.size
    o, d = camera_tiles(S, dev)
    tracer = make_tracer(scene, packet=4096 if S >= 64 else 1024,
                         sweep=False, sort=None, device=dev)
    tracer(o, d)  # builds the kernels on first use, warms up
    out, dt = timed(lambda: tracer(o, d), dev)
    t = out.t.cpu().numpy()
    hit = np.isfinite(t)
    rate = S * S / dt
    print(f"camera tracer: {S * S} rays in {1e3 * dt:.1f} ms "
          f"({rate / 1e6:.2f} M rays/s on {dev.type}), hit {hit.mean():.3f}")
    write_pnm(args.out, depth_image(t, S))
    print(f"wrote {args.out}")

    # the free-ray tracer: an arbitrary batch, results in input order
    ro, rd = free_rays(a)
    ro_t, rd_t = torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev)
    free = make_tracer(scene, packet=1024, sweep=False, sort="octmorton",
                       plan="key", device=dev)
    unplanned = make_tracer(scene, packet=1024, sweep=False, sort="octmorton",
                            device=dev)
    hits = free(ro_t, rd_t)
    ref = unplanned(ro_t, rd_t)
    sync(dev)
    plan_equal = bool(torch.equal(hits.t.view(torch.int32),
                                  ref.t.view(torch.int32))
                      and torch.equal(hits.shape_id, ref.shape_id))
    assert plan_equal, "the key plan changed the free-ray tracer's results"
    free_hit = float(torch.isfinite(hits.t).float().mean())
    print(f"free-ray tracer: {N_FREE} rays, hit {free_hit:.3f} "
          f"(results in input order, equal to the unplanned tracer's)")
    return {"device": str(dev), "triangles": int(a.shape[0]),
            "width": int(scene.width), "build_s": dt_build, "size": S,
            "rays": S * S, "seconds": dt, "rays_per_s": rate,
            "hit_fraction": float(hit.mean()), "out": args.out,
            "free_rays": N_FREE, "free_hit_fraction": free_hit,
            "plan_equal": plan_equal,
            "outputs": {"o": o.cpu().numpy(), "d": d.cpu().numpy(), "t": t,
                        "shape_id": out.shape_id.cpu().numpy()}}


if __name__ == "__main__":
    main()
