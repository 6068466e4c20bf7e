"""A real mesh end to end on the port: OBJ file -> scene -> camera render ->
gradients (twin of ``examples/obj_render.py``).

The reference validates against a Sponza .obj loaded through obj-rs
(``src/testbase.rs:618-634``). Here a nontrivial architectural OBJ is
generated (a colonnade: floor slab, columns with octagonal shafts, lintel
beams; quads and n-gons that exercise the loader's fan triangulation),
loaded through ``io.obj.load_obj_triangles``, and run through the whole
pipeline:

  OBJ text -> load_obj_triangles -> build_tight_scene -> camera closest-hit
  depth render (``diff.render_depth_fast``) -> depth image (binary PGM) ->
  one vertex-gradient step through the differentiable path.

Run: python -m bvh_tpu_torch.examples.obj_render [--size 512]
     [--out obj_render.ppm] [--obj PATH] [--cpu]
(without ``--obj`` the colonnade is written to a temporary file; ``--cpu``
runs the plain PyTorch path on the CPU at a size of at most 64.)
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

import numpy as np
import torch

from ..diff import render_depth_fast
from ..diff.camera import camera_rays
from ..io.obj import load_obj_triangles
from ..ops import build_tight_scene
from ._common import pick_device, sync, timed, write_pnm

EYE = (0.0, 9.0, 16.0)
LOOK_AT = (0.0, 2.5, 0.0)
UP = (0.0, 1.0, 0.0)
FOV_DEG = 55.0
BACKGROUND = 40.0  # the depth of a miss
PULL = 0.1  # the gradient step's target: every hit this much closer


def generate_colonnade_obj(path: str, n_cols: int = 8, sides: int = 8) -> None:
    """Writes a colonnade scene as OBJ text (quads + n-gon caps)."""
    verts: list[tuple[float, float, float]] = []
    faces: list[list[int]] = []

    def v(x, y, z):
        verts.append((x, y, z))
        return len(verts)

    def box(x0, y0, z0, x1, y1, z1):
        i = [v(x0, y0, z0), v(x1, y0, z0), v(x1, y1, z0), v(x0, y1, z0),
             v(x0, y0, z1), v(x1, y0, z1), v(x1, y1, z1), v(x0, y1, z1)]
        faces.extend([[i[0], i[1], i[2], i[3]], [i[5], i[4], i[7], i[6]],
                      [i[4], i[0], i[3], i[7]], [i[1], i[5], i[6], i[2]],
                      [i[3], i[2], i[6], i[7]], [i[4], i[5], i[1], i[0]]])

    def column(cx, cz, r, h):
        lo = [v(cx + r * math.cos(2 * math.pi * k / sides),
                0.0,
                cz + r * math.sin(2 * math.pi * k / sides)) for k in range(sides)]
        hi = [v(cx + r * math.cos(2 * math.pi * k / sides),
                h,
                cz + r * math.sin(2 * math.pi * k / sides)) for k in range(sides)]
        for k in range(sides):
            k2 = (k + 1) % sides
            faces.append([lo[k], lo[k2], hi[k2], hi[k]])
        faces.append(list(reversed(lo)))  # n-gon caps: fan-triangulated
        faces.append(hi)

    half = n_cols * 2.0
    box(-half - 2, -0.5, -6.0, half + 2, 0.0, 6.0)  # floor slab
    for i in range(n_cols):
        x = -half + 1.5 + i * 4.0
        column(x, -4.0, 0.6, 7.0)
        column(x, 4.0, 0.6, 7.0)
    box(-half - 1, 7.0, -5.0, half + 1, 7.8, -3.0)  # lintels
    box(-half - 1, 7.0, 3.0, half + 1, 7.8, 5.0)

    with open(path, "w") as fh:
        fh.write("# generated colonnade scene (see examples/obj_render.py)\n")
        for x, y, z in verts:
            fh.write(f"v {x:.6f} {y:.6f} {z:.6f}\n")
        for f in faces:
            fh.write("f " + " ".join(str(i) for i in f) + "\n")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", default="obj_render.ppm")
    ap.add_argument("--obj", default=None,
                    help="path to an .obj (a generated colonnade if absent)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU (size <= 64)")
    args = ap.parse_args(argv)
    if args.cpu:
        args.size = min(args.size, 64)
    return args


def load_triangles(obj_path):
    """The OBJ's triangles (numpy a, b, c) and the path read; without a
    path, the generated colonnade through a temporary file."""
    if obj_path is not None:
        return load_obj_triangles(obj_path), obj_path
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "colonnade.obj")
        generate_colonnade_obj(path)
        print(f"generated {path}")
        return load_obj_triangles(path), "colonnade (generated)"


def main(argv=None) -> dict:
    args = parse(argv)
    dev = pick_device(args.cpu)
    (a, b, c), src = load_triangles(args.obj)
    print(f"loaded {src}: {a.shape[0]} triangles")

    scene, dt_build = timed(lambda: build_tight_scene(a, b, c), dev)
    print(f"build: {dt_build * 1e3:.0f} ms "
          f"(W={scene.width}, {scene.num_nodes} upper nodes)")

    S = args.size
    cam = camera_rays(np.float32(EYE), np.float32(LOOK_AT), np.float32(UP),
                      FOV_DEG, S, S, device=dev)
    tris = tuple(torch.from_numpy(x).to(dev) for x in (a, b, c))

    def render(verts):
        return render_depth_fast(scene, cam, *verts, background=BACKGROUND,
                                 packet=2048, device=dev)

    depth, hit = render(tris)  # builds the kernels on first use, warms up
    hf = float(hit.float().mean())
    (depth, hit), dt = timed(lambda: render(tris), dev)
    rate = S * S / dt
    print(f"render {S}x{S}: {dt * 1e3:.0f} ms ({rate / 1e6:.2f} M rays/s "
          f"on {dev.type}, hit {hf:.1%})")

    # one differentiable step: pull every hit PULL closer to the camera; the
    # loss is the sum over hits of (depth - target)^2
    target = torch.where(hit, depth - PULL, depth)
    leaves = tuple(x.clone().requires_grad_(True) for x in tris)
    d, h = render(leaves)
    loss = torch.where(h, (d - target) ** 2, 0.0).sum()
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    sync(dev)
    gnorm = float(sum(float((g.double() ** 2).sum()) for g in grads)) ** 0.5
    print(f"gradient step: loss={float(loss):.4f} |grad|={gnorm:.4f}")
    finite = math.isfinite(float(loss)) and math.isfinite(gnorm)
    assert finite, "the loss or its gradient is not finite"

    img = depth.detach().cpu().numpy().reshape(S, S)
    lo, hi = img.min(), img.max()
    write_pnm(args.out,
              (255 * (1.0 - (img - lo) / max(hi - lo, 1e-6))).astype(np.uint8))
    print(f"wrote {args.out}")
    return {"device": str(dev), "triangles": int(a.shape[0]),
            "width": int(scene.width), "build_s": dt_build, "size": S,
            "rays": S * S, "seconds": dt, "rays_per_s": rate,
            "hit_fraction": hf, "loss": float(loss), "grad_norm": gnorm,
            "finite": finite, "out": args.out}


if __name__ == "__main__":
    main()
