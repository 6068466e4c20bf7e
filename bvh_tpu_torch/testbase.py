"""Deterministic scene generation, bit-for-bit compatible with the reference.

The reference builds all benchmark scenes from a splitmix64 stream
(``src/testbase.rs:558-566``) expanded into i32 triples
(``next_point3_raw:568-575``), mapped into f32 points inside a bounds box
(``next_point3:578-597``), and extruded into 12-triangle unit cubes
(``push_cube:489-538``, ``create_n_cubes:608-615``). We reproduce those
bit-for-bit (vectorized in numpy uint64/float32) so that scene content — and
therefore BVH structure and benchmark results — are directly comparable.

Triangles are stored SoA: arrays ``a, b, c`` of shape [N, 3] float32.
"""

from __future__ import annotations

import numpy as np

GOLDEN = np.uint64(0x9E3779B97F4A7C15)
MIX1 = np.uint64(0xBF58476D1CE4E5B9)
MIX2 = np.uint64(0x94D049BB133111EB)
I32_MAX_F32 = np.float32(2147483647)  # rounds to 2**31 in f32, like Rust's `as f32`


def splitmix64_stream(seed: int, n: int) -> np.ndarray:
    """The n outputs of splitmix64 starting from ``seed`` (vectorized).

    splitmix64 advances its state by a constant each call, so call k uses
    state ``seed + (k+1)*GOLDEN`` — embarrassingly parallel.
    """
    with np.errstate(over="ignore"):
        k = np.arange(1, n + 1, dtype=np.uint64)
        x = np.uint64(seed) + k * GOLDEN
        z = x
        z = (z ^ (z >> np.uint64(30))) * MIX1
        z = (z ^ (z >> np.uint64(27))) * MIX2
        return z ^ (z >> np.uint64(31))


def next_point3_raw_stream(seed: int, n: int) -> np.ndarray:
    """n i32 triples, matching ``next_point3_raw`` (``src/testbase.rs:568-575``)."""
    u = splitmix64_stream(seed, n)
    a64 = ((u >> np.uint64(32)) & np.uint64(0xFFFFFFFF)).astype(np.int64) - 0x80000000
    b64 = (u & np.uint64(0xFFFFFFFF)).astype(np.int64) - 0x80000000
    bu = b64.astype(np.uint64)
    rot = (bu << np.uint64(6)) | (bu >> np.uint64(58))
    c64 = a64.astype(np.uint64) ^ rot
    a = a64.astype(np.int32)
    b = b64.astype(np.int32)
    c = c64.astype(np.uint32).astype(np.int32)
    return np.stack([a, b, c], axis=-1)


def next_point3_stream(
    seed: int, n: int, bounds_min: np.ndarray, bounds_max: np.ndarray
) -> np.ndarray:
    """n f32 points uniform inside bounds, matching ``next_point3`` (:578-597)."""
    raw = next_point3_raw_stream(seed, n).astype(np.float32)
    f = (raw / I32_MAX_F32 + np.float32(1.0)) * np.float32(0.5)
    size = (bounds_max - bounds_min).astype(np.float32)
    return bounds_min.astype(np.float32) + f * size


def default_bounds():
    """±100k test-space bounds (``src/testbase.rs:600-605``)."""
    return (
        np.full(3, -100_000.0, np.float32),
        np.full(3, 100_000.0, np.float32),
    )


# Cube corner offsets and the 12-triangle winding of ``push_cube``
# (``src/testbase.rs:489-538``). Corner key: t/b top/bottom, f/b front/back,
# r/l right/left; front is -z.
_TFR = (0.5, 0.5, -0.5)
_TBR = (0.5, 0.5, 0.5)
_TBL = (-0.5, 0.5, 0.5)
_TFL = (-0.5, 0.5, -0.5)
_BFR = (0.5, -0.5, -0.5)
_BBR = (0.5, -0.5, 0.5)
_BBL = (-0.5, -0.5, 0.5)
_BFL = (-0.5, -0.5, -0.5)

_CUBE_TRIS = np.array(
    [
        [_TBR, _TFR, _TFL],
        [_TFL, _TBL, _TBR],
        [_BFL, _BFR, _BBR],
        [_BBR, _BBL, _BFL],
        [_TBL, _TFL, _BFL],
        [_BFL, _BBL, _TBL],
        [_BFR, _TFR, _TBR],
        [_TBR, _BBR, _BFR],
        [_TFL, _TFR, _BFR],
        [_BFR, _BFL, _TFL],
        [_BBR, _TBR, _TBL],
        [_TBL, _BBL, _BBR],
    ],
    dtype=np.float32,
)  # [12, 3 verts, 3 coords]


def create_n_cubes(n: int, bounds=None, seed: int = 0):
    """``n`` deterministic random unit cubes => 12n triangles (SoA a, b, c).

    Matches ``create_n_cubes`` (``src/testbase.rs:608-615``) bit-for-bit.
    """
    if bounds is None:
        bounds = default_bounds()
    bmin, bmax = bounds
    centers = next_point3_stream(seed, n, bmin, bmax)  # [n, 3]
    # [n, 12, 3, 3] = center + corner offsets
    tris = centers[:, None, None, :] + _CUBE_TRIS[None, :, :, :]
    tris = tris.reshape(n * 12, 3, 3).astype(np.float32)
    return tris[:, 0, :], tris[:, 1, :], tris[:, 2, :]


def create_rays(n: int, bounds=None, seed: int = 0):
    """n rays with origin and direction points drawn inside bounds.

    Matches ``create_ray`` (``src/testbase.rs:686-692``): both origin and the
    direction *vector* are next_point3 draws (the direction is not target-origin).
    Returns (origins [n,3], directions [n,3]) with directions unnormalized;
    ``Ray.create`` normalizes like the reference's ``Ray::new``.
    """
    if bounds is None:
        bounds = default_bounds()
    bmin, bmax = bounds
    pts = next_point3_stream(seed, 2 * n, bmin, bmax).reshape(n, 2, 3)
    return pts[:, 0, :], pts[:, 1, :]


def tri_aabbs(a: np.ndarray, b: np.ndarray, c: np.ndarray):
    """Per-triangle AABBs (min, max), each [N, 3]."""
    mn = np.minimum(np.minimum(a, b), c)
    mx = np.maximum(np.maximum(a, b), c)
    return mn, mx


def randomly_transform_scene(
    a: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    amount: int,
    bounds=None,
    max_offset: float | None = None,
    seed: int = 1234,
):
    """Move ``amount`` random triangles to new positions inside bounds.

    Functional analog of ``randomly_transform_scene`` (``src/testbase.rs:640-681``).
    The *selection* shuffle uses numpy's PCG instead of rand's StdRng (the only
    intentional deviation — rand's ChaCha12 shuffle is not worth replicating;
    offsets still come from the splitmix64 stream). Returns new (a, b, c, moved_idx).
    """
    if bounds is None:
        bounds = default_bounds()
    bmin, bmax = bounds
    n = a.shape[0]
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)[:amount]

    mn, mx = tri_aabbs(a[idx], b[idx], c[idx])
    move_min = bmin[None, :] - mn
    move_max = bmax[None, :] - mx
    off = next_point3_stream(seed, amount, np.zeros(3, np.float32), np.ones(3, np.float32))
    offset = move_min + off * (move_max - move_min)
    if max_offset is not None:
        offset = np.clip(offset, -max_offset, max_offset)

    a2, b2, c2 = a.copy(), b.copy(), c.copy()
    a2[idx] += offset
    b2[idx] += offset
    c2[idx] += offset
    return a2, b2, c2, idx


def seed_state_after(n_draws: int, seed: int = 0) -> int:
    """splitmix64 state after ``n_draws`` next_point3 calls from ``seed``.

    Lets a ray stream continue exactly where scene generation left off, like
    the reference benches that thread one mutable seed through scene+rays.
    """
    return int((seed + n_draws * int(GOLDEN)) & 0xFFFFFFFFFFFFFFFF)


def create_dense_mesh(res: int = 362, extent: float = 100.0, seed: int = 0):
    """Deterministic dense connected mesh: a multi-octave wavy heightfield
    over a ``res x res`` grid => ``2*(res-1)^2`` triangles (SoA a, b, c).

    A stand-in for the reference's Sponza scene (``media/sponza.obj`` is a
    stripped large blob in the mirror): architectural-density connected
    geometry with coherent normals, the workload class where camera renders
    hit ~every pixel. res=362 gives ~260k triangles (Sponza is ~262k).
    """
    xs = np.linspace(-extent, extent, res, dtype=np.float32)
    zs = np.linspace(-extent, extent, res, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    # deterministic multi-octave displacement (no RNG: pure trig)
    Y = (
        6.0 * np.sin(X * 0.11 + 1.0) * np.cos(Z * 0.13 + 2.0)
        + 2.5 * np.sin(X * 0.37 + 0.5) * np.sin(Z * 0.29 + 1.7)
        + 1.0 * np.cos(X * 0.83) * np.sin(Z * 0.71 + 0.3)
    ).astype(np.float32)
    V = np.stack([X, Y, Z], axis=-1)  # [res, res, 3]

    v00 = V[:-1, :-1].reshape(-1, 3)
    v10 = V[1:, :-1].reshape(-1, 3)
    v01 = V[:-1, 1:].reshape(-1, 3)
    v11 = V[1:, 1:].reshape(-1, 3)
    # two triangles per quad, consistent upward-facing winding
    a = np.concatenate([v00, v10], axis=0)
    b = np.concatenate([v01, v01], axis=0)
    c = np.concatenate([v10, v11], axis=0)
    return a.astype(np.float32), b.astype(np.float32), c.astype(np.float32)


def aimed_rays(a: np.ndarray, n: int, seed: int = 0, dist: float = 50.0):
    """``n`` rays aimed at the cubes of ``create_n_cubes`` (``a`` holds the
    first vertices, 12 per cube): each starts ``dist`` away from a cube
    centre in a random direction and points at centre + 0.1, cubes taken in
    turn. The aimed workload of the repository's ``bench.py``; nearly every
    ray hits. Returns (origins [n, 3], directions [n, 3]) float32."""
    centers = a.reshape(-1, 12, 3).mean(axis=1)
    idx = np.resize(np.arange(len(centers)), n)
    idx = idx[np.argsort(idx, kind="stable")]
    rng = np.random.default_rng(seed)
    offs = rng.normal(size=(n, 3)).astype(np.float32)
    offs /= np.linalg.norm(offs, axis=1, keepdims=True)
    origins = (centers[idx] + offs * np.float32(dist)).astype(np.float32)
    return origins, (centers[idx] + np.float32(0.1) - origins).astype(np.float32)


def chain_tables(scene, depth: int, K: int = 16):
    """A ``TightScene`` whose trees are a chain ``depth`` groups deep, over
    the first ``15 * (depth - 1) + K`` clusters of ``scene`` (a scene with
    wide tables): group l holds 15 of them as leaf slots and, in slot
    l mod K, the group l + 1, which holds the rest below it; the last group
    holds K leaves. The entry/exit table ``smem_nodes`` is the same tree in
    DFS order. Leaf boxes are the scene's own (a cluster's rows are stored
    relative to its leaf box's centre), an interior box is the union of
    the leaf boxes below it, and the other clusters lie outside both
    trees (``gslot`` lists the chain's clusters' slots only). For tests of
    the deepest tables the walks take."""
    g0 = scene.gnodes
    slot = scene.gslot.astype(np.int64)
    n_cl = 15 * (depth - 1) + K
    if scene.num_clusters < n_cl:
        raise ValueError(f"a chain {depth} deep needs {n_cl} clusters")
    boxes = np.stack([g0[7 * (slot % K) + j, slot // K] for j in range(6)],
                     axis=1)  # [C, 6] leaf boxes: amin (3), amax (3)
    gn = np.full((7 * K + 1, depth), np.nan, np.float32)
    gn[6:7 * K:7] = -1.0  # empty-slot payloads
    gn[7 * K] = 0.0
    gslot = np.zeros(n_cl, np.int32)
    # the clusters of group l: leaves, and the groups below l
    first = [15 * lvl for lvl in range(depth)]
    below = [np.arange(first[lvl], n_cl) for lvl in range(depth)]
    for lvl in range(depth):
        inner = lvl % K if lvl < depth - 1 else -1
        cl = iter(range(first[lvl], first[lvl] + (15 if inner >= 0 else K)))
        for k in range(K):
            if k == inner:
                sub = boxes[below[lvl + 1]]
                gn[7 * k:7 * k + 3, lvl] = sub[:, 0:3].min(axis=0)
                gn[7 * k + 3:7 * k + 6, lvl] = sub[:, 3:6].max(axis=0)
                gn[7 * k + 6, lvl] = lvl + 1
            else:
                c = next(cl)
                gn[7 * k:7 * k + 6, lvl] = boxes[c]
                gn[7 * k + 6, lvl] = -(c + 1)
                gn[7 * K, lvl] += 1 << k
                gslot[c] = lvl * K + k
    # the same tree as an entry/exit table: a node's entry is its first
    # child (or -(cluster+1)), its exit the node after its subtree
    cols = [None]  # the root's column, filled last

    def emit(lvl):
        for k in range(K):
            pay = gn[7 * k + 6, lvl]
            i = len(cols)
            cols.append([*gn[7 * k:7 * k + 6, lvl], pay, i + 1])
            if pay >= 0:
                cols[i][6] = i + 1
                emit(int(pay))
                cols[i][7] = len(cols)
    emit(0)
    all_boxes = boxes[:n_cl]
    cols[0] = [*all_boxes[:, 0:3].min(axis=0), *all_boxes[:, 3:6].max(axis=0),
               1, len(cols)]
    smem = np.asarray(cols, np.float32).T.copy()
    return scene._replace(smem_nodes=smem, gnodes=gn, gslot=gslot,
                          gdepth=depth, sweep_nodes=None, packed_nodes=None,
                          num_nodes=smem.shape[1])
