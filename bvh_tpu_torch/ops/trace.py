"""Closest-hit and any-hit traces over a ``TightScene``, a ``ChainedScene``
and a legacy ``ClusterScene``: the coherence sorts, the ray prologue, the
gates, the walks and the epilogue.

Counterpart of ``sort_rays_device``, ``trace_closest_hit_tight``,
``trace_any_hit_tight``, ``make_tracer``, ``trace_closest_hit_chained``,
``trace_any_hit_chained``, ``sort_rays`` and ``trace_closest_hit`` in
``bvh_tpu/ops/trace.py``. The legacy trace has its own walk and rules
(``ops/cluster_trace.py``); what follows is about the others.
The walk is chosen by the reference's rule (``_traces_wide``): the group
walk (``ops/wide.py``) where the scene has a wide table and neither packed
nodes nor bmat forms, else the entry/exit walk (``ops/tight.py``). The TPU
layouts of the reference's ray prologue (slab and lmat tiles) are not
copied: the kernels read flat ray rows (``ops/wide.py``). The rules are the
reference's Pallas-path rules:

* inverse directions are clamped to ±1e30, so a ray lying in a box's face
  plane counts as touching it;
* the raw ``t`` is the packed key's distance, up to W-1 ulps below the hit
  (pass ``tris`` for the exact winner recompute);
* a hit at ``t >= t_max`` is a miss.

Entry points run on the card unless the caller passes ``device="cpu"``,
where every kernel's plain version runs instead.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..bvh.lbvh import morton_codes
from ..bvh.traverse import HitRecord
from ..device import resolve_device
from ..ray import Ray, ray_intersects_triangle
from .cluster_trace import cluster_trace
from .cluster_trace import ray_rows as cluster_ray_rows
from .sweep import node_records, sweep_gate
from .tight import tight_trace
from .wide import K, group_records, wide_trace

_INF = float("inf")

# Device copies of host-built scene tables, keyed by (array identity,
# device, layout): without it every call would copy the tables to the card
# again. An entry is dropped when its numpy array is garbage-collected.
_DEVICE_TABLE_CACHE: dict[tuple, tuple] = {}


def _dev(arr, device: torch.device, layout=None):
    """A host numpy table as a tensor on ``device``, copied once; with
    ``layout`` (a numpy function of the table, such as
    ``wide.group_records`` or ``sweep.node_records``), that function's
    result, made once."""
    key = (id(arr), str(device), layout)
    ent = _DEVICE_TABLE_CACHE.get(key)
    if ent is not None and ent[0]() is arr:
        return ent[1]
    host = arr if layout is None else layout(arr)
    ten = torch.as_tensor(np.ascontiguousarray(host)).to(device)
    ref = weakref.ref(arr, lambda _r, k=key, c=_DEVICE_TABLE_CACHE: c.pop(k, None))
    _DEVICE_TABLE_CACHE[key] = (ref, ten)
    return ten


def sort_rays_device(origins, directions, bits: int = 6, mode: str = "octant",
                     device=None):
    """Coherence sort on the device. Returns ``(perm, inv)`` int64
    permutations (``perm`` sorts, ``inv`` un-sorts).

    ``mode="octant"``: direction octant, then origin cell (x-major at
    ``bits`` per axis). ``mode="morton"``: origin Morton cell (512^3), then
    the octant. ``mode="octmorton"``: octant major, origin Morton cell minor.
    The argsort is stable, so equal keys keep their input order.
    """
    dev = resolve_device(device)
    o = torch.as_tensor(origins, dtype=torch.float32, device=dev)
    d = torch.as_tensor(directions, dtype=torch.float32, device=dev)
    n = o.shape[0]
    if n == 0:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        return e, e
    octant = ((d[:, 0] > 0).to(torch.int32) * 4
              + (d[:, 1] > 0).to(torch.int32) * 2
              + (d[:, 2] > 0).to(torch.int32))
    lo = o.amin(dim=0)
    hi = o.amax(dim=0)
    if mode == "morton":
        key = ((morton_codes(o, lo, hi) >> 3) << 3) | octant
    elif mode == "octmorton":
        key = (octant << 27) | (morton_codes(o, lo, hi) >> 3)
    elif mode == "octant":
        scale = (2.0 ** bits - 1.0) / torch.clamp_min(hi - lo, 1e-30)
        q = ((o - lo) * scale).to(torch.int32)
        key = ((octant << (3 * bits)) | (q[:, 0] << (2 * bits))
               | (q[:, 1] << bits) | q[:, 2])
    else:
        raise ValueError(f"unknown sort mode {mode!r}")
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=dev)
    return perm, inv


def _ray_rows(rays: Ray, tm: torch.Tensor) -> torch.Tensor:
    """The kernels' ray rows [13, n]: o·inv (3), inv clamped to ±1e30 (3),
    t_max, d (3), o (3)."""
    o, d, inv = rays
    inv_c = torch.clamp(inv, -1.0e30, 1.0e30)
    return torch.stack([*(o * inv_c).unbind(1), *inv_c.unbind(1), tm,
                        *d.unbind(1), *o.unbind(1)])


def _traces_wide(scene) -> bool:
    """Whether the scene's default walk is the group walk: it has a wide
    table and neither packed nodes nor bmat forms (the reference's rule,
    which also fixes the hint format: leaf slot ids g·K+k for the group
    walk, node-table ids for the entry/exit walk)."""
    return (getattr(scene, "gnodes", None) is not None
            and getattr(scene, "bgroups", None) is None
            and getattr(scene, "packed_nodes", None) is None)


def _choose_walk(scene, wide: bool | None) -> bool:
    """The walk a call takes: the scene's default for ``wide=None``; the
    group walk for True, which needs an f32 wide scene; else entry/exit."""
    if wide is None:
        return _traces_wide(scene)
    if wide and not _traces_wide(scene):
        if getattr(scene, "gnodes", None) is None:
            raise ValueError("scene built without wide tables (gnodes)")
        raise ValueError("the group walk reads f32 tables and the default "
                         "leaf test (not a packed or bmat scene)")
    return bool(wide)


def _entry_exit_table(scene):
    """The entry/exit table a walk over ``scene`` reads, and whether it is
    the bf16-packed one."""
    pn = getattr(scene, "packed_nodes", None)
    return (scene.smem_nodes, False) if pn is None else (pn, True)


def _check_packet(packet: int) -> None:
    if packet < 128 or packet & (packet - 1):
        raise ValueError(f"packet must be a power of two >= 128, got {packet}")


def _hints(scene, hints, wide: bool, n: int, packet: int, dev):
    """``hints`` as an int32 [p, n_hints] tensor on ``dev`` (None for no
    hints), checked against the walk's format: leaf slot ids of the wide
    table, or leaf ids of the node table. Packets whose first slot is -1
    are not checked (their hints are off)."""
    if hints is None:
        return None
    h = np.asarray(hints.cpu() if torch.is_tensor(hints) else hints)
    p = -(-n // packet)
    if h.ndim != 2 or h.shape[0] != p:
        raise ValueError(f"hints must be [{p}, n_hints], got {h.shape}")
    if h.shape[1] == 0:
        return None
    h = h.astype(np.int64)
    on = h[h[:, 0] >= 0]
    if wide:
        pay = scene.gnodes[6:7 * K:7]  # [K, Gn] payloads; leaves < 0
        ok = (on >= 0) & (on < pay.size)
        ok[ok] &= pay[on[ok] & (K - 1), on[ok] >> 4] < 0
        what = "leaf slot ids g*K+k of the wide table"
    else:
        table, packed = _entry_exit_table(scene)
        entry = table[3 if packed else 6]
        ok = (on >= 0) & (on < entry.shape[0])
        ok[ok] &= entry[on[ok]] < 0
        what = "leaf ids of the node table"
    if not ok.all():
        raise ValueError(f"hints must be {what} (or -1 in a packet's first "
                         "slot)")
    return torch.as_tensor(h, dtype=torch.int32).to(dev).contiguous()


def _pre_gate(pre_gate, n: int, packet: int, dev):
    if pre_gate is None:
        return None
    p = -(-n // packet)
    g = torch.as_tensor(pre_gate, device=dev).reshape(-1)
    if g.shape[0] != p:
        raise ValueError(f"pre_gate must have {p} entries, got {g.shape[0]}")
    return (g != 0).to(torch.int32).contiguous()


def _walk(scene, rows, packet: int, sweep: bool, bounded: bool, mode: str,
          wide: bool, hints=None, pre_gate=None):
    """The gate (sweep and pre-gate) and the walk over the ray rows:
    ``(t, lane_id)``."""
    dev = rows.device
    table, packed = _entry_exit_table(scene)
    gate = pre_gate
    if sweep:
        swn = scene.sweep_nodes
        if swn is not None:
            gate = sweep_gate(_dev(swn, dev, node_records), rows, packet,
                              pre_gate=pre_gate)
        else:
            gate = sweep_gate(_dev(table, dev, node_records), rows, packet,
                              packed=packed, pre_gate=pre_gate)
    if wide:
        return wide_trace(_dev(scene.gnodes, dev, group_records),
                          _dev(scene.groups, dev), rows, width=int(scene.width),
                          depth=int(scene.gdepth), gate=gate, packet=packet,
                          bounded=bounded, mode=mode, hints=hints)
    return tight_trace(_dev(table, dev, node_records), _dev(scene.groups, dev),
                       rows, width=int(scene.width), packed=packed, gate=gate,
                       packet=packet, bounded=bounded, mode=mode, hints=hints)


def _shape_ids(scene, t, lane_id):
    """Triangle ids of the hits (finite ``t``) through ``scene.tri_map``;
    -1 on a miss."""
    tri_map = _dev(scene.tri_map, t.device)
    return torch.where(torch.isfinite(t),
                       tri_map[lane_id.clamp(0, tri_map.shape[0] - 1)
                               .to(torch.int64)], -1)


def _finish(rays_s: Ray, tris9, t, sid) -> HitRecord:
    """The ``HitRecord`` of raw hits ``(t, sid)``; with ``tris9`` (an
    [n_tris, 9] vertex table) the winners' exact (u, v, t) recomputed."""
    if tris9 is None:
        zero = torch.zeros_like(t)
        return HitRecord(t, zero, zero, sid)
    hit = torch.isfinite(t)
    g9 = tris9[sid.clamp_min(0).to(torch.int64)]
    inter = ray_intersects_triangle(rays_s, g9[:, 0:3], g9[:, 3:6], g9[:, 6:9])
    u = torch.where(hit, inter.u, 0.0)
    v = torch.where(hit, inter.v, 0.0)
    t = torch.where(hit & torch.isfinite(inter.distance), inter.distance, t)
    return HitRecord(t, u, v, sid)


def _trace(scene, rays_s: Ray, tris9, packet: int, sweep: bool, tm,
           bounded: bool, wide: bool, hints=None, pre_gate=None) -> HitRecord:
    """The closest-hit trace on sorted rays ``rays_s``; ``tm`` is the per-ray
    t_max in the same order (+inf when unbounded); ``tris9`` an optional
    [n_tris, 9] vertex table for the exact winner recompute."""
    t, lane_id = _walk(scene, _ray_rows(rays_s, tm), packet, sweep, bounded,
                       "closest", wide, hints, pre_gate)
    if bounded:
        # a leaf hit at t >= t_max (the slab test prunes boxes, not
        # triangles) is a miss
        t = torch.where(t < tm, t, _INF)
    return _finish(rays_s, tris9, t, _shape_ids(scene, t, lane_id))


def _tris9(tris, device) -> torch.Tensor:
    ta, tb, tc = (torch.as_tensor(x, dtype=torch.float32, device=device)
                  for x in tris)
    return torch.cat([ta, tb, tc], dim=1)


def _prepare(rays: Ray, t_max, perm, dev):
    """The rays on ``dev``, sorted by ``perm`` if given, and the per-ray
    t_max in the same order (+inf when None)."""
    rays = Ray(*(x.to(dev) for x in rays))
    r = rays.origin.shape[0]
    if t_max is None:
        tm = torch.full((r,), _INF, dtype=torch.float32, device=dev)
    else:
        tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
        tm = tm.reshape(-1).expand(r).contiguous()
    if perm is not None:
        perm = torch.as_tensor(perm, device=dev).to(torch.int64)
        rays = rays.take(perm)
        tm = tm[perm]
    return rays, tm


def trace_closest_hit_tight(scene, rays: Ray, tris=None, packet: int = 2048,
                            hints=None, t_max=None, sweep: bool = False,
                            wide: bool | None = None, pre_gate=None,
                            start_g=None, perm=None,
                            device=None) -> HitRecord:
    """Closest hit against a ``TightScene``: ``HitRecord(t, u, v, shape_id)``.

    ``tris=(a, b, c)``: recompute the exact (u, v, t) of each winner.
    ``t_max``: scalar or [n] per-ray bound (hits at t >= t_max are misses;
    the bound prunes from the start). ``sweep``: run the sweep gate first
    and skip packets of ``packet`` rays that cannot hit (same results).
    ``wide``: None takes the scene's default walk (``_traces_wide``), True
    the group walk, False the entry/exit walk; the results are the same up
    to the near-tie class. ``hints``: optional [ceil(n / packet), k] leaf
    ids per packet in the default walk's format (wide: leaf slot ids g·K+k;
    entry/exit: node-table ids), narrowphased first to seed the bound; -1 in
    a packet's first slot turns its hints off. ``pre_gate``: optional
    [ceil(n / packet)] gate; packets where it is 0 are reported as misses
    without a walk (and skip the sweep). ``perm``: [n] coherence-sort
    permutation over UNSORTED ``rays`` (and a per-ray ``t_max``); outputs
    come back in sorted order, as if the caller had passed sorted rays.
    ``device``: where to run (None: the card).

    ``start_g`` (the subtree-entry planner's input) is not ported yet and
    raises ``NotImplementedError``.
    """
    if start_g is not None:
        raise NotImplementedError(
            "start_g= is not ported yet (ROADMAP queue 1 item 10)")
    _check_packet(packet)
    walk_wide = _choose_walk(scene, wide)
    dev = resolve_device(device)
    r = rays.origin.shape[0]
    if r == 0:
        z = torch.zeros(0, dtype=torch.float32, device=dev)
        return HitRecord(z, z, z, torch.zeros(0, dtype=torch.int32, device=dev))
    hints_t = _hints(scene, hints, _traces_wide(scene), r, packet, dev)
    if hints_t is not None and walk_wide != _traces_wide(scene):
        # the hint format is the default walk's
        raise ValueError("hints follow the scene's default walk; do not "
                         "override wide= with hints")
    pg = _pre_gate(pre_gate, r, packet, dev)
    rays, tm = _prepare(rays, t_max, perm, dev)
    tris9 = None if tris is None else _tris9(tris, dev)
    return _trace(scene, rays, tris9, packet, sweep, tm, t_max is not None,
                  walk_wide, hints_t, pg)


def trace_any_hit_tight(scene, rays: Ray, t_max=None, packet: int = 2048,
                        sweep: bool = False, wide: bool | None = None,
                        pre_gate=None, perm=None,
                        device=None) -> torch.Tensor:
    """Occlusion: bool [n], True where the ray hits some triangle at
    t < t_max (any triangle at all when ``t_max`` is None).

    The shadow-ray query. A ray stops pruning, and its walk ends, at its
    first hit inside the bound. ``t_max``: scalar or [n] per-ray bound (the
    distance to the light for shadow rays); the packed key truncates t by up
    to width-1 ulps, so an occluder within that band of ``t_max`` may count
    as inside it. ``sweep``, ``wide``, ``pre_gate``, ``perm`` and
    ``device`` as in ``trace_closest_hit_tight``; with ``perm`` the result
    comes back in sorted order.
    """
    _check_packet(packet)
    walk_wide = _choose_walk(scene, wide)
    dev = resolve_device(device)
    r = rays.origin.shape[0]
    if r == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    pg = _pre_gate(pre_gate, r, packet, dev)
    rays, tm = _prepare(rays, t_max, perm, dev)
    t, _ = _walk(scene, _ray_rows(rays, tm), packet, sweep, t_max is not None,
                 "any", walk_wide, pre_gate=pg)
    if t_max is None:
        return torch.isfinite(t)
    return t < tm


def make_tracer(scene, packet: int = 8192, sweep: bool = True,
                sort: str | None = "octant", bits: int = 2, tris=None,
                plan: str | None = None, device=None):
    """The whole closest-hit pipeline over a fixed scene as one callable:
    raw (origins, directions) in, ``HitRecord`` in the callers' ray order
    out. The scene's default walk serves every scene the build makes.

    ``sort``: "octant", "morton" or "octmorton" coherence sort inside the
    call, or None when the rays are already coherent (camera tiles).
    ``tris``: optional (a, b, c) vertex arrays for the exact winner
    recompute, copied to the device once. ``device``: where to run (None:
    the card). ``plan`` (the subtree-entry planner) is not ported yet.
    """
    if plan is not None:
        raise NotImplementedError(
            "plan= is not ported yet (ROADMAP queue 1 item 10)")
    _check_packet(packet)
    if sort not in (None, "octant", "morton", "octmorton"):
        raise ValueError(f"unknown sort mode {sort!r}")
    dev = resolve_device(device)
    wide = _traces_wide(scene)
    table, _ = _entry_exit_table(scene)
    swn = scene.sweep_nodes if scene.sweep_nodes is not None else table
    # copy the tables to the device once, in the layouts the kernels read
    for t, layout in ((scene.gnodes, group_records) if wide
                      else (table, node_records), (scene.groups, None),
                      (scene.tri_map, None), (swn, node_records)):
        _dev(t, dev, layout)
    tris9 = None if tris is None else _tris9(tris, dev)

    def tracer(origins, directions) -> HitRecord:
        o = torch.as_tensor(origins, dtype=torch.float32, device=dev)
        d = torch.as_tensor(directions, dtype=torch.float32, device=dev)
        if o.shape[0] == 0:
            z = torch.zeros(0, dtype=torch.float32, device=dev)
            return HitRecord(z, z, z, torch.zeros(0, dtype=torch.int32,
                                                  device=dev))
        if sort is None:
            rays_s = Ray.create(o, d, device=dev)
        else:
            perm, inv = sort_rays_device(o, d, bits=bits, mode=sort, device=dev)
            od = torch.cat([o, d], dim=1)[perm]
            rays_s = Ray.create(od[:, 0:3], od[:, 3:6], device=dev)
        tm = torch.full((o.shape[0],), _INF, dtype=torch.float32, device=dev)
        out = _trace(scene, rays_s, tris9, packet, sweep, tm, False, wide)
        if sort is None:
            return out
        # un-permute as int32 bit patterns, so every t, u, v moves exactly
        cols = [out.t.view(torch.int32), out.shape_id]
        if tris9 is not None:
            cols += [out.u.view(torch.int32), out.v.view(torch.int32)]
        comb = torch.stack(cols, dim=1)[inv]
        t = comb[:, 0].contiguous().view(torch.float32)
        if tris9 is None:
            return HitRecord(t, out.u, out.v, comb[:, 1].contiguous())
        return HitRecord(t, comb[:, 2].contiguous().view(torch.float32),
                         comb[:, 3].contiguous().view(torch.float32),
                         comb[:, 1].contiguous())

    return tracer


# ---- the legacy ClusterScene trace ------------------------------------------

def sort_rays(origins, directions):
    """Coherence sort on the host (numpy): direction octant, then origin
    cell on a 64³ grid over the origins' bounds. Returns ``(perm, inv)``
    int64 numpy permutations (``perm`` sorts, ``inv`` un-sorts)."""
    o = np.asarray(origins)
    d = np.asarray(directions)
    octant = ((d[:, 0] > 0).astype(np.int64) << 2
              | (d[:, 1] > 0).astype(np.int64) << 1
              | (d[:, 2] > 0).astype(np.int64))
    lo = o.min(axis=0)
    hi = o.max(axis=0)
    q = ((o - lo) / np.maximum(hi - lo, 1e-30) * 63.0).astype(np.int64)
    key = (octant << 18) | (q[:, 0] << 12) | (q[:, 1] << 6) | q[:, 2]
    perm = np.argsort(key, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return perm, inv


def trace_closest_hit(scene, rays: Ray, tris=None, packet: int = 1024,
                      precision=None, skip_narrow: bool = False,
                      device=None) -> HitRecord:
    """Closest hit against a legacy ``ClusterScene``:
    ``HitRecord(t, u, v, shape_id)``.

    The walk is ``ops/cluster_trace.py``'s (the slab test with the
    unclamped inverse direction, so a ray in a box's face plane misses that
    box). ``tris=(a, b, c)``: recompute the exact (u, v, t) of each winner;
    without it ``t`` is the packed key's value, up to 127 ulps below the
    hit. ``skip_narrow``: the broadphase-only walk, every ray a miss.
    ``packet`` (a multiple of 128) and ``precision`` are taken for call
    compatibility with the reference, whose packet kernel runs its leaf test
    as a matrix product at that precision; they change nothing in the
    port's per-ray float32 walk. ``device``: where to run (None: the card).
    """
    if packet <= 0 or packet % 128:
        raise ValueError(f"packet must be a positive multiple of 128, got {packet}")
    dev = resolve_device(device)
    r = rays.origin.shape[0]
    if r == 0:
        z = torch.zeros(0, dtype=torch.float32, device=dev)
        return HitRecord(z, z, z, torch.zeros(0, dtype=torch.int32, device=dev))
    rays = Ray(*(x.to(dev) for x in rays))
    t, lane_id = cluster_trace(_dev(scene.smem_nodes, dev),
                               _dev(scene.smem_cc, dev),
                               _dev(scene.tris_rel, dev),
                               _dev(scene.a_lo, dev),
                               cluster_ray_rows(rays),
                               relative=bool(scene.relative),
                               skip_narrow=skip_narrow)
    tris9 = None if tris is None else _tris9(tris, dev)
    return _finish(rays, tris9, t, _shape_ids(scene, t, lane_id))


# ---- chained scenes ---------------------------------------------------------

def _part_root_gate(rows, root, bound, packet: int) -> torch.Tensor:
    """int32 [ceil(n / packet)] gate of one chained part: 1 where some ray
    of the packet hits the part's root box ``root`` (amin, amax) closer than
    its ``bound``. Reads ray rows 0-5 (o·inv and inv, clamped) as the
    kernels do; a partial last packet looks only at its real rays."""
    n = rows.shape[1]
    oix, oiy, oiz, ix, iy, iz = rows[0:6]
    ax, ay, az, bx, by, bz = root
    t1 = ax * ix - oix
    t2 = bx * ix - oix
    u1 = ay * iy - oiy
    u2 = by * iy - oiy
    v1 = az * iz - oiz
    v2 = bz * iz - oiz
    tmin = torch.maximum(torch.maximum(torch.minimum(t1, t2),
                                       torch.minimum(u1, u2)),
                         torch.minimum(v1, v2))
    tmax = torch.minimum(torch.minimum(torch.maximum(t1, t2),
                                       torch.maximum(u1, u2)),
                         torch.maximum(v1, v2))
    zero = torch.zeros((), dtype=torch.float32, device=rows.device)
    fired = (tmax >= torch.maximum(tmin, zero)) & (tmin < bound)
    p = -(-n // packet)
    padded = torch.zeros(p * packet, dtype=torch.bool, device=rows.device)
    padded[:n] = fired
    return padded.view(p, packet).any(dim=1).to(torch.int32)


def _chain_ids(chained, dev) -> torch.Tensor:
    """The parts' global triangle ids concatenated behind a -1 in slot 0."""
    return torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev)]
                     + [_dev(i, dev).to(torch.int32) for i in chained.orig_ids])


def trace_closest_hit_chained(chained, rays: Ray, tris=None, packet: int = 2048,
                              precision=None, t_max=None, sweep: bool = True,
                              perm=None, device=None) -> HitRecord:
    """Closest hit against a ``ChainedScene``: ``HitRecord(t, u, v,
    shape_id)`` with global triangle ids.

    The parts run in turn, each with the per-ray best raw t so far as its
    bound (bounded mode), gated per packet by the part's root box
    (``_part_root_gate``) and, with ``sweep``, the sweep gate. A part's hit
    replaces the best only when strictly closer, so a tie goes to the
    earlier part. Ids are mapped once at the end. ``tris``, ``t_max``,
    ``perm`` and ``device`` as in ``trace_closest_hit_tight``; ``precision``
    is taken for call compatibility and changes nothing.

    The grazing-edge class (the adjacent triangle of an edge wins, t within
    0.3%) can double at part boundaries, where the two triangles of an edge
    lie in different parts; pass ``tris`` for the exact t of the winner.
    """
    _check_packet(packet)
    dev = resolve_device(device)
    r = rays.origin.shape[0]
    if r == 0:
        z = torch.zeros(0, dtype=torch.float32, device=dev)
        return HitRecord(z, z, z, torch.zeros(0, dtype=torch.int32, device=dev))
    rays_s, tm = _prepare(rays, t_max, perm, dev)
    rows = _ray_rows(rays_s, tm)  # row 6 is each part's bound
    # the per-ray best raw t, each part's bound: +inf where t_max is not
    # finite, then only ever a finite hit t
    best_t = torch.where(torch.isfinite(tm), tm, _INF)
    best_loc = torch.zeros(r, dtype=torch.int64, device=dev)  # 0: the -1 slot
    off = 1
    for part, ids in zip(chained.parts, chained.orig_ids):
        rows[6] = best_t
        gate = _part_root_gate(rows, _dev(part.smem_nodes, dev)[:6, 0], best_t,
                               packet)
        t, lane_id = _walk(part, rows, packet, sweep, True, "closest",
                           _traces_wide(part), pre_gate=gate)
        t = torch.where(t < best_t, t, _INF)
        sid = _shape_ids(part, t, lane_id)
        closer = torch.isfinite(t) & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_loc = torch.where(closer, sid.to(torch.int64) + off, best_loc)
        off += int(np.shape(ids)[0])
    best_id = _chain_ids(chained, dev)[best_loc]
    if t_max is not None:
        best_t = torch.where(best_t < tm, best_t, _INF)
        best_id = torch.where(torch.isfinite(best_t), best_id, -1)
    tris9 = None if tris is None else _tris9(tris, dev)
    return _finish(rays_s, tris9, best_t, best_id)


def trace_any_hit_chained(chained, rays: Ray, t_max=None, packet: int = 2048,
                          precision=None, sweep: bool = True, perm=None,
                          device=None) -> torch.Tensor:
    """Occlusion over a ``ChainedScene``: bool [n], True where the ray hits
    some triangle at t < t_max (any triangle when ``t_max`` is None).

    The parts run in turn; an occluded ray's bound drops to 0 for the later
    parts, whose root gate then closes its packet once all of its rays are
    occluded. Options as in ``trace_any_hit_tight``; ``precision`` is taken
    for call compatibility and changes nothing.
    """
    _check_packet(packet)
    dev = resolve_device(device)
    r = rays.origin.shape[0]
    if r == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    rays_s, tm0 = _prepare(rays, t_max, perm, dev)
    rows = _ray_rows(rays_s, tm0)  # row 6 is each part's bound
    occ = torch.zeros(r, dtype=torch.bool, device=dev)
    for part in chained.parts:
        tm = torch.where(occ, 0.0, tm0)
        rows[6] = tm
        gate = _part_root_gate(rows, _dev(part.smem_nodes, dev)[:6, 0], tm,
                               packet)
        t, _ = _walk(part, rows, packet, sweep, True, "any", _traces_wide(part),
                     pre_gate=gate)
        occ = occ | (t < tm)
    return occ
