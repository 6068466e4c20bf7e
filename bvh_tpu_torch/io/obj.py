"""Minimal Wavefront OBJ triangle loader (SoA output), the JAX package's
``bvh_tpu/io/obj.py``: vertices and polygon faces, polygons of more than 3
vertices fan-triangulated from their first vertex, every other record type
ignored. Negative (relative) indices are supported.
"""

from __future__ import annotations

import numpy as np


def load_obj_triangles(path: str):
    """Returns SoA triangle arrays (a, b, c), each [N, 3] float32 (numpy)."""
    verts: list[list[float]] = []
    tris: list[tuple[int, int, int]] = []

    def resolve(tok: str, nverts: int) -> int:
        idx = int(tok.split("/", 1)[0])
        return idx - 1 if idx > 0 else nverts + idx

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                parts = line.split()[1:]
                nv = len(verts)
                idx = [resolve(p, nv) for p in parts]
                for k in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[k], idx[k + 1]))

    v = np.asarray(verts, np.float32).reshape(-1, 3)
    t = np.asarray(tris, np.int64).reshape(-1, 3)
    return v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
