"""Batched stackless traversal of a ``FlatBvh``: the general pure-tensor
path, and the traversal records.

Counterpart of ``bvh_tpu/bvh/traverse.py``. The whole query batch walks
the flat entry/exit layout in lock step: each lane has its own node cursor,
and a step gathers every lane's node, tests it and moves the cursor to
``entry`` (descend) or ``exit`` (skip). The reference's ``lax.while_loop``
becomes a loop of PyTorch operations on the batch's device: finished lanes
are masked and keep their state, and the stop test (every cursor past the
last node) is read on the host every ``CHECK_EVERY`` steps, not every step;
at that read the finished lanes are also dropped from the batch the next
steps work on. Between reads a step has a fixed shape and never waits for
the device: every lane of the batch runs the leaf test (on its clamped
shape, the result masked, as in the reference), and results are written
with selects. On the card the window's step is captured once as a CUDA
graph and replayed ``CHECK_EVERY`` times (a step is ~100 small launches,
whose host cost bounds the walk), so a query's hooks (``nearest_to``'s
distance) must not wait for the device. A finished lane's step changes
nothing, so results do not depend on ``CHECK_EVERY``. Nothing here is a CUDA kernel (the reference
computes these outside any Pallas kernel); inputs may be float32 or float64
and any D where the query allows it.

Variants: ``traverse`` collects every shape whose box chain passes a query
test into a fixed buffer with a count (``traverse_all`` regrows the buffer
until every lane fits); ``closest_hit_triangles`` fuses the walk with
Moller-Trumbore and prunes by slab entry (a subtree is entered only when
its entry distance beats the best hit); ``any_hit_triangles`` stops a lane
at its first hit; ``nearest_to`` prunes by the box distance. The
brute-force oracles test everything against everything.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import obs
from ..ray import Ray, ray_intersects_triangle
from ..tri import point_triangle_distance_squared
from .flat import FlatBvh

CHECK_EVERY = 8  # lock-step steps between host reads of the stop test
BRUTE_ELEMENTS = 1 << 24  # (query, shape) pairs a brute-force chunk holds


class HitRecord(NamedTuple):
    """Closest hit per ray: +inf distance == miss; shape_id == -1 on miss."""

    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    shape_id: torch.Tensor


def _tensors(flat: FlatBvh, device) -> FlatBvh:
    """The tree's arrays as tensors on ``device`` (no copy where they are
    there), the int fields as int64 for indexing."""
    f = FlatBvh(*(torch.as_tensor(x).to(device) for x in flat))
    return f._replace(entry=f.entry.long(), exit=f.exit.long(),
                      shape=f.shape.long())


def _gather_node(flat: FlatBvh, cursor: torch.Tensor):
    """Each lane's node record; a finished lane's cursor is clamped."""
    c = cursor.clamp(max=flat.num_nodes - 1)
    return (flat.aabb_min[c], flat.aabb_max[c], flat.entry[c], flat.exit[c],
            flat.shape[c])


def _lockstep(cursor: torch.Tensor, n: int, step, done=None) -> None:
    """Runs ``step(idx)`` (one masked step of the lanes ``idx``) until every
    lane's cursor is past ``n`` or ``done(idx)`` holds for it, reading the
    stop test on the host every ``CHECK_EVERY`` steps and dropping the
    finished lanes there."""
    def finished(idx):
        out = cursor[idx] >= n
        return out if done is None else out | done(idx)

    idx = torch.arange(cursor.shape[0], device=cursor.device)
    idx = idx[~finished(idx)]
    obs.count("traverse.host_reads")
    graphs = _Graphs() if cursor.is_cuda else None
    while idx.numel():
        if graphs is not None:
            graphs.replay(step, idx, CHECK_EVERY)
        else:
            for _ in range(CHECK_EVERY):
                step(idx)
        obs.count("traverse.steps", CHECK_EVERY)
        idx = idx[~finished(idx)]
        obs.count("traverse.host_reads")


class _Graphs:
    """A walk's windows on the card: each window's steps have one shape,
    so the step is captured once as a CUDA graph (on a side stream, as
    capture requires) and replayed in order on the current stream, which
    spares the host ~100 launches a step. The walk's graphs share one
    memory pool: a window's graph is replayed whole before the next is
    captured, so the next may reuse its blocks, and the pool holds one
    step's temporaries. The last graph is kept until the next is
    captured: the pool lives while a graph holds it."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream()
        self.last = None

    def replay(self, step, idx: torch.Tensor, times: int) -> None:
        graph = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream()
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            graph.capture_begin(pool=self.pool)
            step(idx)
            graph.capture_end()
        main.wait_stream(self.side)
        self.last = graph
        for _ in range(times):
            graph.replay()


def _slab_entry(nmin, nmax, origin, inv):
    """``(hit, t_entry, t_exit)`` of each lane's box, the reference's
    intersection slice (entry clamped to 0; NaN in a corner product
    misses)."""
    lbr = (nmin - origin) * inv
    rtr = (nmax - origin) * inv
    has_nan = torch.any(torch.isnan(lbr) | torch.isnan(rtr), dim=-1)
    tmin = torch.clamp_min(torch.minimum(lbr, rtr).amax(dim=-1), 0.0)
    tmax = torch.maximum(lbr, rtr).amin(dim=-1)
    return ~has_nan & (tmin <= tmax), tmin, tmax


def _flat_rays(rays: Ray):
    """The rays as [R, D] and their batch shape."""
    batch = rays.origin.shape[:-1]
    return Ray(*(x.reshape(-1, x.shape[-1]) for x in rays)), batch


def _take(obj, idx: torch.Tensor, r: int):
    """The lanes ``idx`` of a (nested) NamedTuple of tensors whose leading
    axis is the batch of ``r`` lanes."""
    if torch.is_tensor(obj):
        return obj[idx] if obj.dim() and obj.shape[0] == r else obj
    return type(obj)(*(_take(x, idx, r) for x in obj))


def _device_of(obj) -> torch.device:
    """The device of a (nested) NamedTuple's first tensor."""
    if torch.is_tensor(obj):
        return obj.device
    return next(_device_of(x) for x in obj
                if torch.is_tensor(x) or isinstance(x, tuple))


def _flat_query(obj, nb: int):
    """A query with its first ``nb`` (batch) axes flattened into one."""
    if torch.is_tensor(obj):
        return obj.reshape((-1,) + tuple(obj.shape[nb:]))
    return type(obj)(*(_flat_query(x, nb) for x in obj))


def traverse(flat: FlatBvh, query, max_hits: int = 64):
    """The shapes whose boxes ``query`` (any query of ``queries.py``)
    passes, with the boxes of every ancestor: ``(hits [..., max_hits]
    int32, count [...] int32)``, the slots past ``count`` -1. A lane that
    collects more than ``max_hits`` keeps counting while its last slot is
    overwritten: ``count > max_hits`` says the buffer overflowed
    (``traverse_all`` regrows it)."""
    n = flat.num_nodes
    dev = _device_of(query)
    if n == 0:
        # as the reference: no node to probe the batch with
        return (torch.full((max_hits,), -1, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    f = _tensors(flat, dev)
    batch = query.intersects_node(f.aabb_min[0], f.aabb_max[0]).shape
    q = _flat_query(query, len(batch))
    r = math.prod(batch)
    hits = torch.full((r, max_hits), -1, dtype=torch.int32, device=dev)
    count = torch.zeros(r, dtype=torch.int32, device=dev)
    cursor = torch.zeros(r, dtype=torch.int64, device=dev)

    def step(idx):
        cur = cursor[idx]
        active = cur < n
        nmin, nmax, entry, exit_, shape = _gather_node(f, cur)
        hit = _take(q, idx, r).intersects_node(nmin, nmax)
        is_leaf = entry < 0
        record = active & is_leaf & hit
        _set_slot(hits, idx, count[idx], shape.to(torch.int32), record)
        count[idx] += record.to(torch.int32)
        cursor[idx] = torch.where(active, torch.where(is_leaf | ~hit, exit_,
                                                      entry), cur)

    _lockstep(cursor, n, step)
    return (hits.reshape(tuple(batch) + (max_hits,)),
            count.reshape(batch))


def _set_slot(buf: torch.Tensor, idx, count, val, write) -> None:
    """``buf[idx, min(count, K - 1)] = val`` where ``write``, in place,
    without waiting for the device (the others rewrite their slot)."""
    slot = count.clamp(max=buf.shape[1] - 1).long()
    buf[idx, slot] = torch.where(write, val, buf[idx, slot])


def traverse_all(flat: FlatBvh, query, max_hits: int = 64,
                 grow_limit: int = 1 << 20):
    """``traverse`` without overflow: reruns with a larger buffer (the
    observed count rounded up to a power of two, counts being exact when
    slots saturate) until every lane fits. Raises when a lane collects more
    than ``grow_limit`` shapes (the query covers most of the scene: use
    ``brute_force_collect``). Returns ``(hits, count)`` with ``count <=
    hits.shape[-1]``."""
    k = max_hits
    while True:
        hits, count = traverse(flat, query, max_hits=k)
        need = int(count.max()) if count.numel() else 0
        if need <= k:
            return hits, count
        if need > grow_limit:
            raise ValueError(
                f"traverse_all: a lane collected {need} hits "
                f"(> grow_limit={grow_limit}); use brute_force_collect")
        while k < need:
            k *= 2


def closest_hit_triangles(flat: FlatBvh, rays: Ray, tri_a, tri_b,
                          tri_c) -> HitRecord:
    """The closest hit of every ray against the triangles ``tri_*`` [N, 3]
    under the tree (leaf shapes index them), with ordered pruning: a subtree
    or leaf is entered only when its slab entry distance is below the
    ray's best hit. Float32 or float64, on the rays' device."""
    rr, batch = _flat_rays(rays)
    r = rr.origin.shape[0]
    dt, dev = rr.origin.dtype, rr.origin.device
    t_best = torch.full((r,), float("inf"), dtype=dt, device=dev)
    u_best = torch.zeros(r, dtype=dt, device=dev)
    v_best = torch.zeros(r, dtype=dt, device=dev)
    id_best = torch.full((r,), -1, dtype=torch.int32, device=dev)
    n = flat.num_nodes
    if n:
        f = _tensors(flat, dev)
        cursor = torch.zeros(r, dtype=torch.int64, device=dev)

        def step(idx):
            cur = cursor[idx]
            active = cur < n
            nmin, nmax, entry, exit_, shape = _gather_node(f, cur)
            box, tmin, _ = _slab_entry(nmin, nmax, rr.origin[idx],
                                       rr.inv_direction[idx])
            tb = t_best[idx]
            useful = box & (tmin < tb)
            is_leaf = entry < 0
            si = shape.clamp_min(0)
            inter = ray_intersects_triangle(rr.take(idx), tri_a[si],
                                            tri_b[si], tri_c[si])
            closer = active & is_leaf & useful & (inter.distance < tb)
            t_best[idx] = torch.where(closer, inter.distance, tb)
            u_best[idx] = torch.where(closer, inter.u, u_best[idx])
            v_best[idx] = torch.where(closer, inter.v, v_best[idx])
            id_best[idx] = torch.where(closer, shape.to(torch.int32),
                                       id_best[idx])
            cursor[idx] = torch.where(
                active, torch.where(is_leaf | ~useful, exit_, entry), cur)

        _lockstep(cursor, n, step)
    return HitRecord(*(x.reshape(batch) for x in (t_best, u_best, v_best,
                                                   id_best)))


def any_hit_triangles(flat: FlatBvh, rays: Ray, tri_a, tri_b, tri_c,
                      t_max=None) -> torch.Tensor:
    """True where a ray hits any triangle (closer than ``t_max`` when it is
    given, a scalar or one per ray); a lane stops at its first hit."""
    rr, batch = _flat_rays(rays)
    r = rr.origin.shape[0]
    dt, dev = rr.origin.dtype, rr.origin.device
    found = torch.zeros(r, dtype=torch.bool, device=dev)
    n = flat.num_nodes
    if n == 0:
        return found.reshape(batch)
    tm = (torch.full((r,), float("inf"), dtype=dt, device=dev) if t_max is None
          else torch.as_tensor(t_max, dtype=dt, device=dev).expand(batch)
          .reshape(-1))
    f = _tensors(flat, dev)
    cursor = torch.zeros(r, dtype=torch.int64, device=dev)

    def step(idx):
        cur = cursor[idx]
        fi = found[idx]
        active = (cur < n) & ~fi
        nmin, nmax, entry, exit_, shape = _gather_node(f, cur)
        box, tmin, _ = _slab_entry(nmin, nmax, rr.origin[idx],
                                   rr.inv_direction[idx])
        ti = tm[idx]
        useful = box & (tmin < ti)
        is_leaf = entry < 0
        si = shape.clamp_min(0)
        inter = ray_intersects_triangle(rr.take(idx), tri_a[si], tri_b[si],
                                        tri_c[si])
        found[idx] = fi | (active & is_leaf & useful
                           & (inter.distance < ti))
        cursor[idx] = torch.where(
            active, torch.where(is_leaf | ~useful, exit_, entry), cur)

    _lockstep(cursor, n, step, done=lambda idx: found[idx])
    return found.reshape(batch)


def nearest_to(flat: FlatBvh, points: torch.Tensor, distance_squared_fn):
    """The nearest shape to each point: ``(shape_id [...] int32, distance
    [...])``, the distance the root of the best squared distance.

    ``distance_squared_fn(points [m, D], shape_id [m] int64) -> [m]`` is the
    exact squared distance of each point to the shape; the walk prunes a
    subtree when its box's ``min_distance_squared`` is not below the best.
    As in the reference, every step calls it for every lane of the batch
    (a lane not at a tested leaf with a clamped id, its result dropped), so
    it must accept any valid id."""
    batch = points.shape[:-1]
    pts = points.reshape(-1, points.shape[-1])
    r = pts.shape[0]
    best_d2 = torch.full((r,), float("inf"), dtype=pts.dtype,
                         device=pts.device)
    best_id = torch.full((r,), -1, dtype=torch.int32, device=pts.device)
    n = flat.num_nodes
    if n:
        f = _tensors(flat, pts.device)
        cursor = torch.zeros(r, dtype=torch.int64, device=pts.device)

        def step(idx):
            cur = cursor[idx]
            active = cur < n
            nmin, nmax, entry, exit_, shape = _gather_node(f, cur)
            p = pts[idx]
            half = (nmax - nmin) * 0.5
            q = torch.abs(p - (nmin + half)) - half
            node_d2 = torch.sum(torch.clamp_min(q, 0.0) ** 2, dim=-1)
            bd = best_d2[idx]
            useful = node_d2 < bd
            is_leaf = entry < 0
            si = shape.clamp_min(0)
            d2 = distance_squared_fn(p, si)
            closer = active & is_leaf & useful & (d2 < bd)
            best_d2[idx] = torch.where(closer, d2, bd)
            best_id[idx] = torch.where(closer, si.to(torch.int32),
                                       best_id[idx])
            cursor[idx] = torch.where(
                active, torch.where(is_leaf | ~useful, exit_, entry), cur)

        _lockstep(cursor, n, step)
    return best_id.reshape(batch), torch.sqrt(best_d2).reshape(batch)


def nearest_to_triangles(flat: FlatBvh, points: torch.Tensor, tri_a, tri_b,
                         tri_c):
    """The nearest triangle to each point: ``nearest_to`` with the exact
    point-triangle distance (``tri.py``)."""

    def tri_d2(pts, si):
        return point_triangle_distance_squared(pts, tri_a[si], tri_b[si],
                                               tri_c[si])

    return nearest_to(flat, points, tri_d2)


# ---- brute-force oracles --------------------------------------------------------

def brute_force_closest_hit(rays: Ray, tri_a, tri_b, tri_c) -> HitRecord:
    """The closest hit of every ray against every triangle, in chunks of
    rays of at most ``BRUTE_ELEMENTS`` (ray, triangle) pairs."""
    rr, batch = _flat_rays(rays)
    r, nt = rr.origin.shape[0], tri_a.shape[0]
    chunk = max(1, BRUTE_ELEMENTS // max(nt, 1))
    parts = []
    for s in range(0, r, chunk):
        sub = Ray(*(x[s:s + chunk, None, :] for x in rr))
        inter = ray_intersects_triangle(sub, tri_a, tri_b, tri_c)
        best = torch.argmin(inter.distance, dim=-1, keepdim=True)
        t = inter.distance.gather(-1, best)[:, 0]
        sid = torch.where(torch.isfinite(t), best[:, 0].to(torch.int32), -1)
        parts.append((t, inter.u.gather(-1, best)[:, 0],
                      inter.v.gather(-1, best)[:, 0], sid))
    if not parts:
        e = rr.origin.new_zeros(0)
        parts = [(e, e, e, torch.zeros(0, dtype=torch.int32,
                                       device=e.device))]
    return HitRecord(*(torch.cat(x).reshape(batch) for x in zip(*parts)))


def brute_force_collect(query, shape_min, shape_max) -> torch.Tensor:
    """A bool mask [..., N]: which shapes' boxes ``query`` passes."""
    shape_min = torch.as_tensor(shape_min)
    shape_max = torch.as_tensor(shape_max)
    batch = query.intersects_node(shape_min[0], shape_max[0]).shape
    view = (shape_min.shape[0],) + (1,) * len(batch) + (shape_min.shape[-1],)
    mask = query.intersects_node(shape_min.reshape(view),
                                 shape_max.reshape(view))
    return mask.movedim(0, -1)


def closest_hit_chunked(flat: FlatBvh, rays: Ray, tri_a, tri_b, tri_c,
                        chunk: int = 8192) -> HitRecord:
    """``closest_hit_triangles`` over a large batch in chunks of ``chunk``
    rays, so that a chunk's walk lasts as long as its own longest ray. The
    ray count must be a multiple of ``chunk``."""
    r = rays.origin.shape[0]
    if r % chunk:
        raise ValueError(f"ray count {r} not a multiple of chunk {chunk}")
    parts = [closest_hit_triangles(flat, Ray(*(x[s:s + chunk] for x in rays)),
                                   tri_a, tri_b, tri_c)
             for s in range(0, r, chunk)]
    return HitRecord(*(torch.cat(x) for x in zip(*parts)))
