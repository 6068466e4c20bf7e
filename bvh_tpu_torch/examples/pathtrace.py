"""A multi-bounce path tracer on the port's kernels (twin of
``examples/pathtrace.py``).

The wavefront renderer (``render.make_pathtracer``) runs closest-hit waves,
next-event shadow waves (``trace_any_hit_tight`` with a per-ray ``t_max``:
the occlusion query the reference writes as ``traverse`` plus its own
intersection, src/bvh/bvh_impl.rs:350-378) and Lambertian bounces, all on
the device; the host makes one call a frame.

The bounce directions come from a ``torch.Generator`` seeded with 0 where
the original passes ``jax.random.key(0)``: the two draw different numbers,
so the noise, and the image, differ from the original's, while the scene,
the camera and the light are the same.

Run: python -m bvh_tpu_torch.examples.pathtrace [--size 256] [--bounces 2]
     [--out pathtrace.ppm] [--cpu]
Writes a PPM image and prints ray counts and rates. (``--cpu``: the plain
PyTorch path on the CPU at a size of at most 64.)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import testbase as tb
from ..ops import build_tight_scene
from ..render import make_pathtracer
from ._common import pick_device, timed, write_pnm

SEED = 0  # the bounce directions' generator


def make_scene():
    """A heightfield floor plus a few cube 'sculptures' standing on it."""
    fa, fb, fc = tb.create_dense_mesh(res=96, extent=24.0)  # floor
    cubes = []
    rng = np.random.default_rng(7)
    for k in range(6):
        ca, cb, cc = tb.create_n_cubes(1, (np.full(3, -0.5, np.float32),
                                           np.full(3, 0.5, np.float32)), seed=k)
        s = 1.5 + rng.uniform(0, 1.5)
        off = np.float32([rng.uniform(-14, 14), 9.0 + rng.uniform(0, 3), rng.uniform(-14, 14)])
        cubes.append((ca * s + off, cb * s + off, cc * s + off))
    a = np.concatenate([fa] + [x[0] for x in cubes])
    b = np.concatenate([fb] + [x[1] for x in cubes])
    c = np.concatenate([fc] + [x[2] for x in cubes])
    return a.astype(np.float32), b.astype(np.float32), c.astype(np.float32)


def camera_rays(size: int):
    """Pinhole camera looking down at the scene, row-major."""
    fov = 0.7
    eye = np.float32([0.0, 18.0, 26.0])
    look = np.float32([0.0, 0.0, 0.0])
    fwd = (look - eye) / np.linalg.norm(look - eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    ys, xs = np.meshgrid(np.linspace(1, -1, size), np.linspace(-1, 1, size), indexing="ij")
    d = (fwd[None, None] + fov * (xs[..., None] * right[None, None]
                                  + ys[..., None] * up[None, None]))
    d = d.reshape(-1, 3).astype(np.float32)
    o = np.tile(eye, (size * size, 1)).astype(np.float32)
    return o, d


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--bounces", type=int, default=2)
    ap.add_argument("--out", default="pathtrace.ppm")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU (size <= 64)")
    args = ap.parse_args(argv)
    if args.cpu:
        args.size = min(args.size, 64)
    return args


def main(argv=None) -> dict:
    args = parse(argv)
    dev = pick_device(args.cpu)
    a, b, c = make_scene()
    print(f"scene: {a.shape[0]} triangles")
    scene, dt_build = timed(lambda: build_tight_scene(a, b, c), dev)
    print(f"build: {dt_build * 1e3:.0f} ms "
          f"(W={scene.width}, {scene.num_nodes} upper nodes)")

    o, d = camera_rays(args.size)
    npx = o.shape[0]
    tracer = make_pathtracer(scene, (a, b, c), bounces=args.bounces,
                             packet=2048, device=dev)
    o_t, d_t = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)

    def frame():
        return tracer(o_t, d_t, torch.Generator(device=dev).manual_seed(SEED))

    frame()  # builds the kernels on first use, warms up
    color, dt = timed(frame, dev)
    total_rays = npx * 2 * (args.bounces + 1)
    rate = total_rays / dt
    print(f"traced {total_rays / 1e6:.2f} M rays in {dt:.2f}s "
          f"({rate / 1e6:.2f} M rays/s on {dev.type}, wavefront)")

    col = color.cpu().numpy()
    finite = bool(np.isfinite(col).all())
    non_negative = bool((col >= 0).all())
    assert finite and non_negative, "a colour is not finite or negative"
    img = np.clip(col.reshape(args.size, args.size, 3), 0, 1)
    write_pnm(args.out, (np.sqrt(img) * 255).astype(np.uint8))  # gamma 2.0
    lum = float(img.mean())
    print(f"wrote {args.out}  (mean luminance {lum:.3f})")
    return {"device": str(dev), "triangles": int(a.shape[0]),
            "width": int(scene.width), "build_s": dt_build, "size": args.size,
            "bounces": args.bounces, "rays": total_rays, "seconds": dt,
            "rays_per_s": rate, "finite": finite,
            "non_negative": non_negative, "mean_luminance": lum,
            "out": args.out}


if __name__ == "__main__":
    main()
