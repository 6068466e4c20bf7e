"""The scene maker ``create_n_cubes``: a frozen copy of the upstream crate's
120k-triangle bench scene, so that later changes to the program cannot move
what is measured. A configuration names its maker by this file's name.

It reproduces svenstaro/bvh's ``create_n_cubes``
(``src/testbase.rs:489-538, 558-615``) bit for bit: a splitmix64 stream
expanded into i32 triples, mapped into f32 points inside the +-100k bounds
and extruded into 12-triangle unit cubes. Triangles are SoA: ``a, b, c``
each [N, 3] float32 numpy.
"""

from __future__ import annotations

import numpy as np

GOLDEN = np.uint64(0x9E3779B97F4A7C15)
MIX1 = np.uint64(0xBF58476D1CE4E5B9)
MIX2 = np.uint64(0x94D049BB133111EB)
I32_MAX_F32 = np.float32(2147483647)  # rounds to 2**31, like Rust's `as f32`
BOUND = 100_000.0  # the crate's test-space bounds, +-BOUND on every axis


def splitmix64_stream(seed: int, n: int) -> np.ndarray:
    """The ``n`` outputs of splitmix64 from state ``seed``: call k uses state
    ``seed + (k + 1) * GOLDEN``."""
    with np.errstate(over="ignore"):
        k = np.arange(1, n + 1, dtype=np.uint64)
        z = np.uint64(seed) + k * GOLDEN
        z = (z ^ (z >> np.uint64(30))) * MIX1
        z = (z ^ (z >> np.uint64(27))) * MIX2
        return z ^ (z >> np.uint64(31))


def next_point3_stream(seed: int, n: int) -> np.ndarray:
    """``n`` f32 points inside the bounds (``next_point3_raw`` and
    ``next_point3``, ``src/testbase.rs:568-597``)."""
    u = splitmix64_stream(seed, n)
    a64 = ((u >> np.uint64(32)) & np.uint64(0xFFFFFFFF)).astype(np.int64) \
        - 0x80000000
    b64 = (u & np.uint64(0xFFFFFFFF)).astype(np.int64) - 0x80000000
    bu = b64.astype(np.uint64)
    rot = (bu << np.uint64(6)) | (bu >> np.uint64(58))
    c64 = a64.astype(np.uint64) ^ rot
    raw = np.stack([a64.astype(np.int32), b64.astype(np.int32),
                    c64.astype(np.uint32).astype(np.int32)], axis=-1)
    f = (raw.astype(np.float32) / I32_MAX_F32 + np.float32(1.0)) \
        * np.float32(0.5)
    lo = np.full(3, -BOUND, np.float32)
    return lo + f * (np.full(3, BOUND, np.float32) - lo)


# corner offsets and the 12-triangle winding of ``push_cube``
# (t/b top/bottom, f/b front/back, r/l right/left; front is -z)
_TFR, _TBR, _TBL, _TFL = ((0.5, 0.5, -0.5), (0.5, 0.5, 0.5),
                          (-0.5, 0.5, 0.5), (-0.5, 0.5, -0.5))
_BFR, _BBR, _BBL, _BFL = ((0.5, -0.5, -0.5), (0.5, -0.5, 0.5),
                          (-0.5, -0.5, 0.5), (-0.5, -0.5, -0.5))
_CUBE_TRIS = np.array([
    [_TBR, _TFR, _TFL], [_TFL, _TBL, _TBR], [_BFL, _BFR, _BBR],
    [_BBR, _BBL, _BFL], [_TBL, _TFL, _BFL], [_BFL, _BBL, _TBL],
    [_BFR, _TFR, _TBR], [_TBR, _BBR, _BFR], [_TFL, _TFR, _BFR],
    [_BFR, _BFL, _TFL], [_BBR, _TBR, _TBL], [_TBL, _BBL, _BBR],
], dtype=np.float32)  # [12 triangles, 3 vertices, 3 coordinates]


def create_n_cubes(n: int, seed: int = 0):
    """``n`` random unit cubes, 12 triangles each (the crate's
    ``create_n_cubes``)."""
    centers = next_point3_stream(seed, n)
    tris = (centers[:, None, None, :] + _CUBE_TRIS[None]).reshape(n * 12, 3, 3)
    tris = tris.astype(np.float32)
    return tris[:, 0].copy(), tris[:, 1].copy(), tris[:, 2].copy()


make = create_n_cubes  # what a configuration's ``scene.args`` are passed to
SMALL = {"n": 50, "seed": 0}  # the CPU tests' args: 600 triangles
