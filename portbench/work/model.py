"""The frozen work model: the operations and bytes a batch needs, from the
benchmark's own tree and counting walks, never from the program's counters
or tables, so that a change to the program's walks cannot move the work
its kernels' roofline divides by.

Operations: each test costs a constant, frozen here at the values the
program's cost model carried when the benchmark was written (float32
operations, an FMA counted as two): a ray-box slab test 25, a ray-triangle
test 44, a point-box distance 18, a point-triangle distance 41. Bytes:
each input read once and each output written once, and the scene's
triangles read once a batch. The peaks are an H100 SXM's published
float32 rate outside the tensor cores and its HBM bandwidth.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from . import bvh, walk

VERSION = 1  # bump when the model's arithmetic changes: it keys the caches
SLAB_OPS = 25
RAY_TRI_OPS = 44
BOX_DIST_OPS = 18
POINT_TRI_OPS = 41
RAY_IN_BYTES = 24  # origin and direction, float32
HIT_OUT_BYTES = 16  # t, u, v and the triangle id
POINT_IN_BYTES = 12
NEAREST_OUT_BYTES = 8  # the triangle id and the distance
TRI_BYTES = 36
PEAK_OPS = 67e12  # float32 operations a second
PEAK_BYTES = 3.35e12  # bytes a second
SAMPLE = 16384  # rays or points a run's counts are taken over


def _key(*parts) -> str:
    h = hashlib.sha256(str(VERSION).encode())
    for p in parts:
        h.update(p if isinstance(p, bytes) else repr(p).encode())
    return h.hexdigest()[:20]


def tree(tris_np, cache: Path) -> dict:
    """The model's tree over numpy triangles ``tris_np``, from ``cache`` when
    it holds one for these triangles, as numpy arrays and ``depth``."""
    a, b, c = tris_np
    path = cache / f"tree-{_key(a.tobytes(), b.tobytes(), c.tobytes())}.npz"
    if path.exists():
        with np.load(path) as z:
            return {k: z[k] for k in z.files} | {"depth": int(z["depth"])}
    t = bvh.build(a, b, c)
    out = t._asdict()
    cache.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".part.npz")
    np.savez(tmp, **out)
    tmp.replace(path)
    return out


def counts(tree_np: dict, tris, sample, points: bool, cache: Path,
           key: tuple) -> dict:
    """Tests a unit of ``sample`` needs, on average: ``{"box": ..., "prim":
    ...}``. ``sample`` is ``(o, d)`` rays or ``(p,)`` points, [n, 3] float32
    tensors on the device of ``tris``; ``key`` names the sample for the
    cache (cell, seed, sample size)."""
    path = cache / f"counts-{_key(key, points)}.json"
    if path.exists():
        return json.loads(path.read_text())
    dev = tris[0].device
    t = {k: (torch.as_tensor(v, device=dev) if k != "depth" else v)
         for k, v in tree_np.items()}
    if points:
        box, prim, _ = walk.point_walk(t, tris, sample[0])
    else:
        box, prim, _ = walk.ray_walk(t, tris, *sample)
    out = {"box": float(box.double().mean()),
           "prim": float(prim.double().mean()), "units": int(box.shape[0])}
    cache.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out))
    return out


def bound(c: dict, units: int, n_tris: int, points: bool) -> dict:
    """Operations, bytes and the least time in ms a batch of ``units`` rays
    or points needs on the chip, from the counts ``c``."""
    if points:
        ops = units * (c["box"] * BOX_DIST_OPS + c["prim"] * POINT_TRI_OPS)
        nbytes = units * (POINT_IN_BYTES + NEAREST_OUT_BYTES)
    else:
        ops = units * (c["box"] * SLAB_OPS + c["prim"] * RAY_TRI_OPS)
        nbytes = units * (RAY_IN_BYTES + HIT_OUT_BYTES)
    nbytes += n_tris * TRI_BYTES
    return {"ops": ops, "bytes": nbytes,
            "bound_ms": max(ops / PEAK_OPS, nbytes / PEAK_BYTES) * 1e3}
