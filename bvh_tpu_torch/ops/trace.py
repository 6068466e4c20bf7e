"""Closest-hit and any-hit traces over a ``TightScene``, a ``ChainedScene``
and a legacy ``ClusterScene``: the coherence sorts, the ray prologue, the
gates, the walks and the epilogue.

Counterpart of ``sort_rays_device``, ``trace_closest_hit_tight``,
``trace_any_hit_tight``, ``make_tracer``, the seeders and planners
(``compute_seed_hints``, ``trace_closest_hit_seeded``, ``make_seeder``,
``make_planner``, ``make_key_planner``), ``trace_closest_hit_chained``,
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

Each call of ``make_tracer``'s tracer, ``trace_closest_hit_tight`` and
``trace_any_hit_tight`` is one ``obs`` span ``trace`` with four stages:
``sort`` (the coherence sort and the rays' gather), ``prologue`` (the rays'
inverse directions, the t_max fill, the kernels' ray rows), ``walk`` (the
gates and the walk's launch) and ``epilogue`` (the bounded mask, the
triangle ids, the winner recompute and the un-permute: one launch of
``ops/epilogue.py``'s kernel on the card). On the card ``make_tracer``'s
``sort`` is ``ops/order.py``'s key kernel and the argsort, and its
``prologue`` the order's rows kernel, which gathers the rays into the rows
and writes the un-sort. The chained traces
are a span ``trace_chained`` with a ``walk`` a part.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import obs
from ..bvh.lbvh import morton_codes
from ..bvh.traverse import HitRecord
from ..device import resolve_device
from ..ray import Ray, ray_intersects_triangle
from .cluster import wide_group_meta
from .cluster_trace import check_f32, cluster_trace
from .cluster_trace import ray_rows as cluster_ray_rows
from .epilogue import closest_epilogue
from .order import MODES as SORT_MODES
from .order import ray_key, ray_rows
from .sweep import node_records, sweep_gate
from .tight import tight_trace
from .wide import WIDE_DMAX  # noqa: F401  (a public layout constant)
from .wide import K, group_records, wide_trace

_INF = float("inf")
# the reference's layout constants: its default packet (8 sublanes x 128
# lanes; the entry points here default to 2048, as the reference's do) and
# the group walk's per-ray stack depth (``wide.WIDE_DMAX``)
PACKET = 1024

# Device copies of host-built scene tables, keyed by (array identity,
# device, layout): without it every call would copy the tables to the card
# again; and the layouts of tensor tables (device builds, refits, updates),
# made once a tensor. An entry is dropped when its array is
# garbage-collected.
_DEVICE_TABLE_CACHE: dict[tuple, tuple] = {}


def _dev(arr, device: torch.device, layout=None):
    """A scene table as a tensor on ``device``; with ``layout`` (a function
    of the table, such as ``wide.group_records`` or
    ``sweep.node_records``), that function's result.

    A numpy table is copied once. A tensor stays on its device when that is
    ``device`` (no copy), and its layout is made there, once a tensor (again
    after an in-place change), so that a table made on the card never goes
    through the host. A copy or a layout made counts one ``table_upload``
    and its ``table_upload_bytes``."""
    tensor = torch.is_tensor(arr)
    if tensor and layout is None:
        out = arr.to(device)
        if out is not arr:
            _uploaded(out)
        return out
    version = arr._version if tensor else None
    key = (id(arr), str(device), layout)
    ent = _DEVICE_TABLE_CACHE.get(key)
    if ent is not None and ent[0]() is arr and ent[2] == version:
        return ent[1]
    if tensor:
        ten = layout(arr.to(device)).contiguous()
    else:
        host = arr if layout is None else layout(arr)
        ten = torch.as_tensor(np.ascontiguousarray(host)).to(device)
    ref = weakref.ref(arr, lambda _r, k=key, c=_DEVICE_TABLE_CACHE: c.pop(k, None))
    _DEVICE_TABLE_CACHE[key] = (ref, ten, version)
    _uploaded(ten)
    return ten


def _uploaded(ten: torch.Tensor) -> None:
    obs.count("table_upload")
    obs.count("table_upload_bytes", ten.numel() * ten.element_size())


def sort_rays_device(origins, directions, bits: int = 6, mode: str = "octant",
                     device=None):
    """Coherence sort on the device. Returns ``(perm, inv)`` int64
    permutations (``perm`` sorts, ``inv`` un-sorts).

    ``mode="octant"``: direction octant, then origin cell (x-major at
    ``bits`` per axis). ``mode="morton"``: origin Morton cell (512^3), then
    the octant. ``mode="octmorton"``: octant major, origin Morton cell minor.
    The argsort is stable, so equal keys keep their input order. On the
    card the key is ``ops/order.py``'s kernel (``_sort_key``).
    """
    if mode not in SORT_MODES:
        raise ValueError(f"unknown sort mode {mode!r}")
    dev = resolve_device(device)
    o = torch.as_tensor(origins, dtype=torch.float32, device=dev)
    d = torch.as_tensor(directions, dtype=torch.float32, device=dev)
    n = o.shape[0]
    if n == 0:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        return e, e
    return _order(_sort_key(o, d, bits, mode))


def _on_card(x: torch.Tensor) -> bool:
    """Whether a tensor takes the hand-written kernels (on the card) or
    the plain composition (on the CPU)."""
    return x.device.type != "cpu"


def _carries_grad(*xs) -> bool:
    """Whether any of the tensors ``xs`` is to carry a gradient."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _sort_key(o, d, bits: int, mode: str) -> torch.Tensor:
    """The coherence sort's int32 key of rays ``o``, ``d`` ([n, 3] float32
    on one device): ``ops/order.py``'s kernel on the card (an integer key
    carries no gradient, so the rays go in detached), the plain composition
    elsewhere; the same bits."""
    if _on_card(o):
        return ray_key(o.detach().contiguous(), d.detach().contiguous(),
                       mode, bits)
    return _sort_key_plain(o, d, bits, mode)


def _sort_key_plain(o, d, bits: int, mode: str) -> torch.Tensor:
    """The key in plain PyTorch: the octant, the origins' bounds and
    ``morton_codes`` (or the octant key's cells)."""
    octant = ((d[:, 0] > 0).to(torch.int32) * 4
              + (d[:, 1] > 0).to(torch.int32) * 2
              + (d[:, 2] > 0).to(torch.int32))
    lo = o.amin(dim=0)
    hi = o.amax(dim=0)
    if mode == "morton":
        return ((morton_codes(o, lo, hi) >> 3) << 3) | octant
    if mode == "octmorton":
        return (octant << 27) | (morton_codes(o, lo, hi) >> 3)
    scale = (2.0 ** bits - 1.0) / torch.clamp_min(hi - lo, 1e-30)
    q = ((o - lo) * scale).to(torch.int32)
    return ((octant << (3 * bits)) | (q[:, 0] << (2 * bits))
            | (q[:, 1] << bits) | q[:, 2])


def _order(key: torch.Tensor):
    """The coherence order of a batch by its sort ``key``: ``(perm, inv)``
    int64, ``perm`` the stable argsort (``_sort_perm``) and ``inv`` its
    inverse."""
    perm = _sort_perm(key)
    return perm, _inverse(perm)


def _sort_perm(key: torch.Tensor) -> torch.Tensor:
    """The stable argsort of a sort ``key`` (int64; equal keys keep their
    input order): the one sort of every coherence order."""
    return torch.argsort(key, stable=True)


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """The permutation that undoes ``perm``, by a scatter."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


def _sorted_rows(o, d, perm):
    """``(rows, inv)``: the walk's ray rows [13, n] of rays ``o``, ``d``
    ([n, 3] float32 on one device) taken in the order ``perm`` (None: as
    given), directions normalised as ``Ray.create`` does it, and the
    permutation that un-sorts them (None without ``perm``).
    ``ops/order.py``'s rows kernel on the card (rows that carry no
    gradient), ``_sorted_rows_plain`` elsewhere; the same bits."""
    if _on_card(o):
        return ray_rows(o.detach().contiguous(), d.detach().contiguous(),
                        perm)
    return _sorted_rows_plain(o, d, perm)


def _sorted_rows_plain(o, d, perm):
    """``_sorted_rows`` in plain PyTorch: ``_inverse``, ``_take``,
    ``Ray.create`` and ``_prologue``."""
    inv = None
    if perm is not None:
        inv = _inverse(perm)
        o, d = _take(perm, o, d)
    return _prologue(Ray.create(o, d, device=o.device), None)[1], inv


def _take(perm, *cols):
    """The batch's columns ``cols`` (float32, [n] or [n, k]; None stays None)
    in the order ``perm``: one ``cat`` and one index where more than one
    column moves, a plain index where one does. A gather moves every bit
    as it is."""
    live = [c for c in cols if c is not None]
    if len(live) == 1:
        moved = [live[0][perm]]
    else:
        flat = torch.cat([c if c.dim() == 2 else c[:, None] for c in live],
                         dim=1)[perm]
        parts = flat.split([c.shape[1] if c.dim() == 2 else 1 for c in live],
                           dim=1)
        moved = [x if c.dim() == 2 else x[:, 0] for x, c in zip(parts, live)]
    it = iter(moved)
    return tuple(None if c is None else next(it) for c in cols)


def _unsort(inv, *cols):
    """``cols`` (int32 or float32 [n]) back in the callers' order: taken by
    ``inv`` as int32 bit patterns in one gather, so every float moves
    exactly."""
    comb = torch.stack([c.view(torch.int32) for c in cols], dim=1)[inv]
    return tuple(comb[:, j].contiguous().view(c.dtype)
                 for j, c in enumerate(cols))


def _ray_rows(rays: Ray, tm: torch.Tensor) -> torch.Tensor:
    """The kernels' ray rows [13, n]: o·inv (3), inv clamped to ±1e30 (3),
    t_max, d (3), o (3). The kernels take float32 rays: float64 ones raise
    (no silent cast)."""
    check_f32(rays)
    o, d, inv = rays
    inv_c = torch.clamp(inv, -1.0e30, 1.0e30)
    return torch.stack([*(o * inv_c).unbind(1), *inv_c.unbind(1), tm,
                        *d.unbind(1), *o.unbind(1)])


def _rays_of_rows(rows: torch.Tensor) -> Ray:
    """The rays of ray rows [13, n] (``_ray_rows``' layout) as views of
    them: the origins, the directions and the clamped inverses."""
    return Ray(rows[10:13].t(), rows[7:10].t(), rows[3:6].t())


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


def _start_g(scene, start_g, wide: bool, n: int, packet: int, dev):
    """``start_g`` ([p] or [p, 2]; numpy, torch or any array numpy reads) as
    an int32 [p, 2] tensor on ``dev``, a [p] input padded with -1; None for
    none. Subtree entry takes the group walk only, and every id must name a
    group of the wide table."""
    if start_g is None:
        return None
    if not wide:
        raise ValueError("start_g (subtree entry) takes the group walk: a "
                         "scene with a wide table, not packed or bmat, and "
                         "wide=None or True")
    if torch.is_tensor(start_g):
        s = start_g.to(device=dev, dtype=torch.int32)
    else:
        s = torch.as_tensor(np.asarray(start_g).astype(np.int32)).to(dev)
    p = -(-n // packet)
    if s.dim() == 1:
        s = torch.stack([s, torch.full_like(s, -1)], dim=1)
    if s.dim() != 2 or tuple(s.shape) != (p, 2):
        raise ValueError(f"start_g must be [{p}] or [{p}, 2], got "
                         f"{tuple(s.shape)}")
    gn = scene.gnodes.shape[1]
    if int(s.max()) >= gn:
        raise ValueError(f"start_g holds a group id >= Gn = {gn}")
    return s.contiguous()


def _pre_gate(pre_gate, n: int, packet: int, dev):
    if pre_gate is None:
        return None
    p = -(-n // packet)
    g = torch.as_tensor(pre_gate, device=dev).reshape(-1)
    if g.shape[0] != p:
        raise ValueError(f"pre_gate must have {p} entries, got {g.shape[0]}")
    return (g != 0).to(torch.int32).contiguous()


def _walk(scene, rows, packet: int, sweep: bool, bounded: bool, mode: str,
          wide: bool, hints=None, pre_gate=None, start_g=None,
          skip_narrow: bool = False):
    """The gate (sweep and pre-gate) and the walk over the ray rows:
    ``(t, lane_id)``; ``start_g`` (group walk) the packets' subtree
    entries; ``skip_narrow`` the entry/exit walk's broadphase-only build.
    One span ``walk``."""
    with obs.span("walk"):
        dev = rows.device
        gate = pre_gate
        if sweep:
            swn = scene.sweep_nodes
            table, packed = ((swn, False) if swn is not None
                             else _entry_exit_table(scene))
            gate = sweep_gate(_dev(table, dev, node_records), rows, packet,
                              packed=packed, pre_gate=pre_gate)
        return _launch_walk(scene, rows, wide, gate=gate, packet=packet,
                            bounded=bounded, mode=mode, hints=hints,
                            start_g=start_g, skip_narrow=skip_narrow)


def _launch_walk(scene, rows, wide: bool, start_g=None,
                 skip_narrow: bool = False, **kw):
    """The walk's launch over the ray rows, as the kernel wrappers return
    it: the group walk (with ``start_g``) where ``wide``, else the
    entry/exit walk (with ``skip_narrow``) over the packed table where the
    scene has one; ``kw`` the wrappers' other options."""
    dev = rows.device
    args = (_dev(scene.groups, dev), rows)
    kw.update(width=int(scene.width), a_lo=_a_lo(scene, dev))
    if wide:
        return wide_trace(_dev(scene.gnodes, dev, group_records), *args,
                          depth=int(scene.gdepth), start_g=start_g, **kw)
    table, packed = _entry_exit_table(scene)
    return tight_trace(_dev(table, dev, node_records), *args, packed=packed,
                       skip_narrow=skip_narrow, **kw)


def _a_lo(scene, dev):
    """The scene's exact-frame table on ``dev`` (``TightScene.a_lo``), with
    which the walks test leaves in the exact cluster frame (``o - cc``
    rounds at far origins whoever built the scene; every scene the port
    builds or loads carries the table); None for a scene whose caller set
    none."""
    a_lo = getattr(scene, "a_lo", None)
    return None if a_lo is None else _dev(a_lo, dev).contiguous()


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


def _epilogue(scene, rays_s: Ray, rows, tris, t, lane_id, tm, bounded: bool,
              inv=None, tris9=None) -> HitRecord:
    """The closest hits of the walk's raw ``(t, lane_id)`` on sorted rays
    ``rays_s`` (``rows`` their ray rows), as one span ``epilogue``: ``tm`` is
    the per-ray t_max in the same order, ``tris`` optional (a, b, c) float32
    tables on the rays' device for the exact winner recompute, ``inv`` an
    optional un-sorting permutation, ``tris9`` the same vertices as one
    [n_tris, 9] table where the caller keeps one (``make_tracer``, whose
    ``tris`` are views of its columns).

    On the card it launches ``ops/epilogue.py``'s kernel; on the CPU, and
    where the recompute is to carry a gradient (a triangle table or the
    sorted rays' origins or directions require grad), the plain composition
    runs, over ``tris9`` or else over (a, b, c) concatenated. Both give the
    same bits.
    """
    with obs.span("epilogue"):
        if _on_card(t) and not _carries_grad(
                rays_s.origin, rays_s.direction, *(tris or ())):
            return closest_epilogue(rows, t, lane_id,
                                    _dev(scene.tri_map, t.device), tris,
                                    bounded, inv)
        if tris9 is None and tris is not None:
            tris9 = torch.cat(tris, dim=1)
        return _epilogue_plain(scene, rays_s, tris9, t, lane_id, tm, bounded,
                               inv)


def _epilogue_plain(scene, rays_s: Ray, tris9, t, lane_id, tm, bounded: bool,
                    inv=None) -> HitRecord:
    """The epilogue in plain PyTorch: the bound mask, ``_shape_ids``,
    ``_finish`` with ``tris9`` (an optional [n_tris, 9] vertex table) and
    ``_unpermute`` by ``inv``."""
    if bounded:
        # a leaf hit at t >= t_max (the slab test prunes boxes, not
        # triangles) is a miss
        t = torch.where(t < tm, t, _INF)
    out = _finish(rays_s, tris9, t, _shape_ids(scene, t, lane_id))
    return out if inv is None else _unpermute(out, inv, tris9 is not None)


def _unpermute(out: HitRecord, inv, exact: bool) -> HitRecord:
    """``out`` in the callers' order (``_unsort``), every t, u, v moved
    exactly (u and v only where ``exact``; else they are zeros and stay)."""
    if exact:
        return HitRecord(*_unsort(inv, *out))
    t, sid = _unsort(inv, out.t, out.shape_id)
    return out._replace(t=t, shape_id=sid)


def _no_hits(dev) -> HitRecord:
    """The ``HitRecord`` of an empty batch on ``dev``."""
    z = torch.zeros(0, dtype=torch.float32, device=dev)
    return HitRecord(z, z, z, torch.zeros(0, dtype=torch.int32, device=dev))


def _tris_on(tris, device) -> tuple:
    """``(a, b, c)`` as float32 tensors on ``device`` with unit column
    stride, as the epilogue kernel reads them (no copy of tensors that are
    already so; a column-major table is copied to row-major)."""
    out = (torch.as_tensor(x, dtype=torch.float32, device=device)
           for x in tris)
    return tuple(x if x.dim() != 2 or x.stride(1) == 1 else x.contiguous()
                 for x in out)


def _tris9(tris, device) -> torch.Tensor:
    return torch.cat(_tris_on(tris, device), dim=1)


def _prepare(rays: Ray, t_max, perm, dev):
    """The spans ``sort`` and ``prologue`` of a trace over rays: the rays on
    ``dev``, sorted by ``perm`` if given, the per-ray t_max in the same
    order (+inf when None) and the kernels' ray rows."""
    with obs.span("sort"):
        rays = Ray(*(x.to(dev) for x in rays))
        tm = None
        if t_max is not None:
            tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
            tm = tm.reshape(-1).expand(rays.origin.shape[0]).contiguous()
        if perm is not None:
            perm = torch.as_tensor(perm, device=dev).to(torch.int64)
            *cols, tm = _take(perm, *rays, tm)
            rays = Ray(*cols)
    with obs.span("prologue"):
        return (rays, *_prologue(rays, tm))


def _prologue(rays: Ray, tm):
    """The prologue of a trace over rays in walk order: ``(tm, rows)``, the
    per-ray t_max (+inf where ``tm`` is None) and the kernels' ray rows."""
    if tm is None:
        tm = torch.full((rays.origin.shape[0],), _INF, dtype=torch.float32,
                        device=rays.origin.device)
    return tm, _ray_rows(rays, tm)


def trace_closest_hit_tight(scene, rays: Ray, tris=None, packet: int = 2048,
                            hints=None, t_max=None, sweep: bool = False,
                            wide: bool | None = None, pre_gate=None,
                            start_g=None, perm=None,
                            skip_narrow: bool = False,
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
    ``start_g``: optional [ceil(n / packet)] or [ceil(n / packet), 2] group
    ids (``make_planner``, ``make_key_planner``; a [p] input is padded with
    -1): each packet walks these subtrees first and then the rest of the
    tree (``ops/wide.py``), which changes no result; ids <= 0 do nothing.
    Group walk only (not ``wide=False``, packed or bmat scenes). With
    ``perm``, ``hints`` and ``start_g`` address the sorted packets.
    ``skip_narrow``: the broadphase-only walk (the reference's rules): the
    entry/exit walk with no leaf test, every ray a miss (t = +inf,
    shape_id = -1, u = v = 0); ``wide=True`` raises, the sweep does not
    run, ``hints`` are not read, ``pre_gate`` still gates.
    ``device``: where to run (None: the card).
    """
    _check_packet(packet)
    if skip_narrow:
        if wide:
            raise ValueError("skip_narrow takes the entry/exit walk (wide=None "
                             "or False)")
        wide, sweep, hints = False, False, None
    walk_wide = _choose_walk(scene, wide)
    dev = resolve_device(device)
    r = rays.origin.shape[0]
    if r == 0:
        return _no_hits(dev)
    with obs.span("trace"):
        hints_t = _hints(scene, hints, _traces_wide(scene), r, packet, dev)
        if hints_t is not None and walk_wide != _traces_wide(scene):
            # the hint format is the default walk's
            raise ValueError("hints follow the scene's default walk; do not "
                             "override wide= with hints")
        sg = _start_g(scene, start_g, walk_wide, r, packet, dev)
        pg = _pre_gate(pre_gate, r, packet, dev)
        tris_d = None if tris is None else _tris_on(tris, dev)
        rays, tm, rows = _prepare(rays, t_max, perm, dev)
        bounded = t_max is not None
        t, lane_id = _walk(scene, rows, packet, sweep, bounded, "closest",
                           walk_wide, hints_t, pg, sg, skip_narrow)
        return _epilogue(scene, rays, rows, tris_d, t, lane_id, tm, bounded)


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
    with obs.span("trace"):
        pg = _pre_gate(pre_gate, r, packet, dev)
        rays, tm, rows = _prepare(rays, t_max, perm, dev)
        t, _ = _walk(scene, rows, packet, sweep, t_max is not None, "any",
                     walk_wide, pre_gate=pg)
        with obs.span("epilogue"):
            return torch.isfinite(t) if t_max is None else t < tm


def make_tracer(scene, packet: int = 8192, sweep: bool = True,
                sort: str | None = "octant", bits: int = 2, tris=None,
                plan: str | None = None, device=None):
    """The whole closest-hit pipeline over a fixed scene as one callable:
    raw (origins, directions) in, ``HitRecord`` in the callers' ray order
    out. The scene's default walk serves every scene the build makes.

    ``sort``: "octant", "morton" or "octmorton" coherence sort inside the
    call, or None when the rays are already coherent (camera tiles).
    ``tris``: optional (a, b, c) vertex arrays for the exact winner
    recompute, copied to the device once. ``plan="key"``: each call plans
    the packets' subtree entries from the sorted origins
    (``make_key_planner``) and walks them first; results do not change.
    It needs the group walk; ``sort="morton"`` suits it best, and with any
    sort (the camera example's free tracer takes "octmorton") the results
    are the unplanned tracer's bit for bit. ``device``: where to run
    (None: the card).
    """
    if plan not in (None, "key"):
        raise ValueError(f"unknown plan {plan!r}")
    _check_packet(packet)
    if sort is not None and sort not in SORT_MODES:
        raise ValueError(f"unknown sort mode {sort!r}")
    dev = resolve_device(device)
    wide = _traces_wide(scene)
    planner = (None if plan is None
               else make_key_planner(scene, packet=packet, device=dev))
    table, _ = _entry_exit_table(scene)
    swn = scene.sweep_nodes if scene.sweep_nodes is not None else table
    # copy the tables to the device once, in the layouts the kernels read
    for t, layout in ((scene.gnodes, group_records) if wide
                      else (table, node_records), (scene.groups, None),
                      (scene.tri_map, None), (swn, node_records)):
        _dev(t, dev, layout)
    # one [n_tris, 9] table, read through views of its columns
    tris9 = None if tris is None else _tris9(tris, dev)
    tris_d = None if tris is None else tris9.split(3, dim=1)

    def tracer(origins, directions) -> HitRecord:
        with obs.span("trace"):
            o = torch.as_tensor(origins, dtype=torch.float32, device=dev)
            d = torch.as_tensor(directions, dtype=torch.float32, device=dev)
            if o.shape[0] == 0:
                return _no_hits(dev)
            with obs.span("sort"):
                perm = (None if sort is None
                        else _sort_perm(_sort_key(o, d, bits, sort)))
            with obs.span("prologue"):
                rows, inv = _sorted_rows(o, d, perm)
                rays_s = _rays_of_rows(rows)
                if (perm is None and tris9 is not None
                        and _carries_grad(o, d) and not rows.requires_grad):
                    # the kernel's rows carry no gradient, so the winners'
                    # recompute reads the rays themselves (a sorted call's
                    # un-sort moves bit patterns and carries none)
                    rays_s = Ray.create(o, d, device=dev)
                sg = None if planner is None else planner(rays_s.origin)
            t, lane_id = _walk(scene, rows, packet, sweep, False, "closest",
                               wide, start_g=sg)
            return _epilogue(scene, rays_s, rows, tris_d, t, lane_id, None,
                             False, inv, tris9)

    return tracer


# ---- seeding hints and subtree-entry planners -------------------------------

def _hint_tables(scene):
    """The seeders' host tables ``(lane_of_tri, node_of_cluster, n_tris,
    W)``, int64 numpy: each triangle's lane in ``groups``, and each
    cluster's hint id in the format of the scene's default walk
    (``_traces_wide``): leaf slot ids g·K+k (``gslot``) on the group walk,
    node-table leaf ids on the entry/exit walk. Counterpart of the
    reference's ``_hint_tables``."""
    tri_map = np.asarray(scene.tri_map)
    n_tris = int(tri_map.max()) + 1
    W = int(scene.width)
    lane_of_tri = np.zeros(n_tris, np.int64)
    valid = tri_map >= 0
    lane_of_tri[tri_map[valid]] = np.nonzero(valid)[0]
    if _traces_wide(scene):
        node_of_cluster = np.asarray(scene.gslot, np.int64)
    else:
        entry = np.asarray(scene.smem_nodes[6])
        leaf_nodes = np.nonzero(entry < 0)[0]
        leaf_cluster = (-entry[leaf_nodes] - 1.0).astype(np.int64)
        node_of_cluster = np.zeros(int(scene.num_clusters), np.int64)
        node_of_cluster[leaf_cluster] = leaf_nodes
    return lane_of_tri, node_of_cluster, n_tris, W


def _sample(rays: Ray, r: int, packet: int, sample_stride: int):
    """Every ``sample_stride``-th ray, or None when there are fewer rays
    than that; the stride must divide the packet (its samples fill whole
    packets)."""
    if r < sample_stride:
        return None
    if packet % sample_stride:
        raise ValueError(f"sample_stride {sample_stride} must divide the "
                         f"packet {packet}")
    return Ray(*(x[::sample_stride] for x in rays))


def compute_seed_hints(scene, rays: Ray, packet: int = 2048,
                       sample_stride: int = 32, k_hints: int = 64,
                       device=None):
    """Seeding hints for ``trace_closest_hit_tight(hints=)``: int32 numpy
    [ceil(n / packet), k_hints], or None when there are fewer rays than
    ``sample_stride``.

    Traces every ``sample_stride``-th ray (at packet ``min(packet, 1024)``)
    and lists, per packet, the first ``k_hints`` distinct clusters its
    samples hit, ascending, in the scene's default walk's hint format; empty
    slots repeat the first, and a packet whose samples all missed gets -1.
    The mapping runs on the host. Counterpart of the reference's
    ``compute_seed_hints``, array-equal to it on the same sampled hits."""
    _check_packet(packet)
    r = rays.origin.shape[0]
    sample = _sample(rays, r, packet, sample_stride)
    if sample is None:
        return None
    pre = trace_closest_hit_tight(scene, sample, packet=min(packet, 1024),
                                  device=device)
    lane_of_tri, node_of_cluster, _, W = _hint_tables(scene)
    sid = pre.shape_id.cpu().numpy()
    p = -(-r // packet)
    rpp = packet // sample_stride
    sid_pad = np.full(p * rpp, -1, np.int64)
    sid_pad[:sid.shape[0]] = sid
    big = np.int64(1 << 40)
    cl = np.where(sid_pad >= 0, lane_of_tri[np.clip(sid_pad, 0, None)] // W,
                  big)
    cl = np.sort(cl.reshape(p, rpp), axis=1)
    first = np.ones_like(cl, dtype=bool)
    first[:, 1:] = cl[:, 1:] != cl[:, :-1]
    first &= cl < big
    rank = np.cumsum(first, axis=1) - 1  # of each distinct cluster in its row
    keep = first & (rank < k_hints)
    hints = np.full((p, k_hints), -1, np.int64)
    hints[np.nonzero(keep)[0], rank[keep]] = node_of_cluster[cl[keep]]
    hints = np.where(hints < 0, hints[:, 0:1], hints)
    return hints.astype(np.int32)


def trace_closest_hit_seeded(scene, rays: Ray, tris=None, packet: int = 2048,
                             sample_stride: int = 32, k_hints: int = 64,
                             device=None) -> HitRecord:
    """Closest hit with sampled-hit seeding: ``compute_seed_hints``, then
    ``trace_closest_hit_tight(hints=)``. Seeding only tightens the bounds
    sooner, so the results are ``trace_closest_hit_tight``'s. ``device`` as
    in ``trace_closest_hit_tight``."""
    hints = compute_seed_hints(scene, rays, packet=packet,
                               sample_stride=sample_stride, k_hints=k_hints,
                               device=device)
    return trace_closest_hit_tight(scene, rays, tris=tris, packet=packet,
                                   hints=hints, device=device)


def make_seeder(scene, packet: int = 2048, sample_stride: int = 32,
                k_hints: int = 64, device=None):
    """``seeder(rays) -> hints``: ``compute_seed_hints`` on the device, with
    no copy to the host: an int32 [ceil(n / packet), k_hints] tensor on
    ``device`` (None: the card), or None when there are fewer rays than
    ``sample_stride``. The hints are the same.

        seeder = make_seeder(scene)
        trace_closest_hit_tight(scene, rays, hints=seeder(rays))
    """
    _check_packet(packet)
    dev = resolve_device(device)
    lane_of_tri, node_of_cluster, n_tris, W = _hint_tables(scene)
    lane_t = torch.as_tensor(lane_of_tri.astype(np.int32)).to(dev)
    node_t = torch.as_tensor(node_of_cluster.astype(np.int32)).to(dev)
    big = 0x7FFFFFF0

    def seeder(rays: Ray):
        r = rays.origin.shape[0]
        sample = _sample(rays, r, packet, sample_stride)
        if sample is None:
            return None
        pre = trace_closest_hit_tight(scene, sample, packet=min(packet, 1024),
                                      device=dev)
        p = -(-r // packet)
        rpp = packet // sample_stride
        sid = torch.full((p * rpp,), -1, dtype=torch.int32, device=dev)
        sid[:pre.shape_id.shape[0]] = pre.shape_id
        cl = torch.where(sid >= 0,
                         lane_t[sid.clamp(0, n_tris - 1).to(torch.int64)] // W,
                         big)
        cl = torch.sort(cl.view(p, rpp), dim=1).values
        first = torch.ones_like(cl, dtype=torch.bool)
        first[:, 1:] = cl[:, 1:] != cl[:, :-1]
        first &= cl < big
        rank = torch.cumsum(first, dim=1) - 1
        # each packet's first k_hints distinct clusters in slots 0..k-1;
        # the others write -1 to the spare slot k
        slot = torch.where(first & (rank < k_hints), rank, k_hints)
        node = node_t[cl.clamp(0, node_t.shape[0] - 1).to(torch.int64)]
        hints = torch.full((p, k_hints + 1), -1, dtype=torch.int32, device=dev)
        hints[torch.arange(p, device=dev)[:, None], slot] = torch.where(
            slot < k_hints, node, -1)
        hints = hints[:, :k_hints]
        return torch.where(hints < 0, hints[:, 0:1], hints).contiguous()

    return seeder


def _wide_meta(scene):
    """The planners' view of a group-walk scene's wide table: ``(anc,
    two_entries)``. ``two_entries``: whether a packet whose entry would be
    the root may enter two depth-1 subtrees instead (the root has more than
    two interior children and the tree is at least two levels deep below
    it)."""
    if not _traces_wide(scene):
        raise ValueError("subtree entry takes a scene whose default walk is "
                         "the group walk (a wide table, not packed or bmat)")
    parent, depth, anc = wide_group_meta(scene.gnodes)
    two = (anc.shape[1] > 1 and int((parent == 0).sum()) > 2
           and int(depth.max()) >= 2)
    return anc, two


def _chain_lca(A, ref, member=None):
    """Per packet: the depth of the deepest group shared by the ancestor
    chains ``A [p, m, D]`` and ``ref [p, 1, D]`` (over the chains where
    ``member [p, m]`` is True, all when None), and that group of ``ref``."""
    same = (A == ref) & (ref >= 0)
    if member is not None:
        same |= ~member[:, :, None]
    same = torch.cumprod(same.all(dim=1).to(torch.int32), dim=1)
    d = same.sum(dim=1) - 1
    ar = torch.arange(A.shape[0], device=A.device)
    return d, ref[:, 0, :][ar, d.clamp(0, A.shape[2] - 1)]


def make_planner(scene, packet: int = 2048, sample_stride: int = 32,
                 k_hints: int = 64, device=None):
    """``plan(rays) -> (hints, start_g)``: ``make_seeder``'s hints and each
    packet's subtree entries, int32 [p, 2] on ``device`` (None: the card).

    Slot 0 is the lowest common ancestor of the groups the packet's hints
    lie in, -1 where that is the root or the samples all missed. Where it
    is the root and the tree allows two entries (``_wide_meta``), the
    samples are split by their ancestor one level below, and the packet
    enters the common ancestor of the first sample's part and that of the
    first sample outside it. Results equal the unplanned trace's for any
    entries. Counterpart of the reference's ``make_planner``, equal to it
    on the same hints.

        hints, start_g = make_planner(scene)(rays)
        trace_closest_hit_tight(scene, rays, hints=hints, start_g=start_g)
    """
    dev = resolve_device(device)
    anc, two_entries = _wide_meta(scene)
    anc_t = torch.as_tensor(anc.astype(np.int32)).to(dev)  # [Gn, D]
    D = anc.shape[1]
    seeder = make_seeder(scene, packet=packet, sample_stride=sample_stride,
                         k_hints=k_hints, device=dev)

    def plan(rays: Ray):
        hints = seeder(rays)
        if hints is None:
            return None, None
        p = hints.shape[0]
        ar = torch.arange(p, device=dev)
        has = hints[:, 0] >= 0
        A = anc_t[(hints.clamp_min(0) >> 4).to(torch.int64)]  # [p, k, D]
        ref = A[:, 0:1, :]
        lca_d, start = _chain_lca(A, ref)
        minus = torch.full((p,), -1, dtype=torch.int32, device=dev)
        e1 = torch.where(has & (lca_d > 0), start, minus)
        e2 = minus
        if two_entries:
            # the samples' ancestors one level below the common one
            sdep = (lca_d + 1).clamp(1, D - 1)
            c1 = A.gather(2, sdep[:, None, None].expand(-1, A.shape[1], 1))[..., 0]
            in1 = c1 == c1[:, 0:1]
            other = ~in1 & (c1 >= 0)
            idx2 = other.to(torch.int32).argmax(dim=1)  # the first outside
            exists2 = other[ar, idx2]
            ref2 = A[ar, idx2][:, None, :]
            in2 = c1 == ref2[:, 0, :].gather(1, sdep[:, None])
            d1, g1 = _chain_lca(A, ref, in1)
            d2, g2 = _chain_lca(A, ref2, in2)
            two = has & (lca_d == 0) & (c1[:, 0] >= 0) & (d1 > 0)
            e1 = torch.where(two, g1, e1)
            e2 = torch.where(two & exists2 & (d2 > 0), g2, e2)
        return hints, torch.stack([e1, e2], dim=1).to(torch.int32).contiguous()

    return plan


def make_key_planner(scene, packet: int = 8192, grid_bits: int = 5,
                     device=None):
    """``plan(sorted_origins) -> start_g``: each packet's subtree entries
    from its origins' bounds, int32 [ceil(n / packet), 2] on ``device``
    (None: the card), with no trace.

    Once a scene, on the host: a cell table of ``2^grid_bits`` cells an axis
    over the root box, each cell holding the deepest group whose subtree box
    covers it whole (groups claim cells parent first; a cell two groups
    cover keeps the first). Per packet: the cells of its origin box's two
    corners name two groups; their lowest common ancestor is the entry, or
    -1 where that is the root. Where it is the root and the tree allows two
    entries, the packet enters the corners' two depth-1 subtrees (one if
    they are the same). Results equal the unplanned trace's for any
    entries. Counterpart of the reference's ``make_key_planner``,
    array-equal to it: the same float32 steps, ``(pt - lo) * inv_step``
    truncated toward zero and clipped."""
    dev = resolve_device(device)
    anc, two_entries = _wide_meta(scene)
    parent = wide_group_meta(scene.gnodes)[0]
    gn = np.asarray(scene.gnodes)
    Gn = gn.shape[1]
    D = anc.shape[1]
    # each group's subtree box: the union of its filled child slots
    bmin = np.full((Gn, 3), np.inf, np.float32)
    bmax = np.full((Gn, 3), -np.inf, np.float32)
    for k in range(K):
        box = gn[7 * k:7 * k + 6]
        valid = np.isfinite(box[0])
        bmin[valid] = np.minimum(bmin[valid], box[0:3, valid].T)
        bmax[valid] = np.maximum(bmax[valid], box[3:6, valid].T)
    cells = 1 << grid_bits
    lo = bmin[0].copy()
    step = np.maximum(bmax[0] - lo, 1e-30) / cells
    cell_group = np.zeros((cells, cells, cells), np.int32)  # the root
    for g in np.nonzero(parent >= 0)[0]:  # ids ascend: parents first
        # the cells g's box covers whole (cut ones stay the parent's)
        i0 = np.clip(np.ceil((bmin[g] - lo) / step - 1e-6).astype(np.int64),
                     0, cells)
        i1 = np.clip(np.floor((bmax[g] - lo) / step + 1e-6).astype(np.int64),
                     0, cells)
        if (i1 <= i0).any():
            continue
        sub = cell_group[i0[0]:i1[0], i0[1]:i1[1], i0[2]:i1[2]]
        sub[sub == parent[g]] = g
    cell_t = torch.as_tensor(cell_group.reshape(-1).astype(np.int64)).to(dev)
    anc_t = torch.as_tensor(anc.astype(np.int32)).to(dev)
    lo_t = torch.as_tensor(lo).to(dev)
    inv_step_t = torch.as_tensor((1.0 / step).astype(np.float32)).to(dev)
    cell_stride = torch.tensor([cells * cells, cells, 1], device=dev)

    def plan(origins) -> torch.Tensor:
        o = torch.as_tensor(origins, dtype=torch.float32, device=dev)
        r = o.shape[0]
        p = -(-r // packet)
        pad = p * packet - r
        if pad:
            o = torch.cat([o, o[-1:].expand(pad, 3)])
        # both corners of every packet's origin box, [2p, 3], in one pass
        # (the plan is a few dozen small launches, so each one counts)
        corners = torch.cat(torch.aminmax(o.view(p, packet, 3), dim=1))
        # each corner's cell: clamped to [-1, cells] first, so that the
        # conversion stays in range; the clip after it gives what it gives
        # on the unclamped value
        x = ((corners - lo_t) * inv_step_t).clamp(-1.0, float(cells))
        q = x.to(torch.int32).clamp(0, cells - 1).to(torch.int64)
        A = anc_t[cell_t[(q * cell_stride).sum(dim=1)]]  # [2p, D]
        A1, A2 = A[:p], A[p:]
        lca_d, start = _chain_lca(A2[:, None], A1[:, None])
        minus = torch.full((p,), -1, dtype=torch.int32, device=dev)
        e1 = torch.where(lca_d > 0, start, minus)
        e2 = minus
        if two_entries:
            d1a, d1b = A1[:, 1], A2[:, 1]
            two = (lca_d == 0) & (d1a >= 0)
            e1 = torch.where(two, d1a, e1)
            e2 = torch.where(two & (d1b >= 0) & (d1b != d1a), d1b, e2)
        return torch.stack([e1, e2], dim=1).to(torch.int32).contiguous()

    return plan


# ---- visit counters ---------------------------------------------------------

def packet_sums(x: torch.Tensor, packet: int) -> torch.Tensor:
    """Per-ray counts ``x [n]`` summed over packets of ``packet`` rays (or
    points) in their order: int64 [ceil(n / packet)]."""
    p = -(-x.shape[0] // packet)
    out = torch.zeros(p * packet, dtype=torch.int64, device=x.device)
    out[:x.shape[0]] = x
    return out.view(p, packet).sum(dim=1)


def _count_rows(rays: Ray, packet: int, dev):
    _check_packet(packet)
    return _prologue(Ray(*(x.to(dev) for x in rays)), None)[1]


def count_visits_tight(scene, rays: Ray, packet: int = 2048, device=None):
    """Node visits and leaf fires of the entry/exit walk, per packet of
    ``packet`` rays in the given order: ``(visits, fires)``, int64 tensors
    [ceil(n / packet)] on ``device`` (None: the card). The walk is
    ungated, unbounded and without hints, over the packed table where the
    scene has one (as the reference counts it).

    A packet's count is the sum over its rays of each ray's own walk's
    count: a ray's visits are the nodes it slab-tests, its fires the leaves
    it narrowphases (``tight_trace_plain(counts=True)``). The reference
    walks one shared cursor a packet and counts that cursor's steps, so its
    numbers are of another unit (about a packet's union of nodes); the
    port's serial unit is a ray's step. On the card this launches the
    kernel's counting build (a debug build, never timed), whose results
    are the timed build's bit for bit."""
    dev = resolve_device(device)
    if rays.origin.shape[0] == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z
    _, _, visits, fires = _launch_walk(scene, _count_rows(rays, packet, dev),
                                       False, packet=packet, counts=True)
    return packet_sums(visits, packet), packet_sums(fires, packet)


def count_visits_wide(scene, rays: Ray, packet: int = 2048, start_g=None,
                      exp: str = "", device=None):
    """Iterations, leaf fires and group tests of the group walk, per packet
    of ``packet`` rays in the given order: ``(iterations, fires,
    group_tests)``, int64 tensors [ceil(n / packet)] on ``device`` (None:
    the card). The walk is ungated, unbounded and without hints;
    ``start_g`` (as in ``trace_closest_hit_tight``) costs the walk with
    subtree entries. ``exp`` names the reference's experimental walks,
    which are not ported: anything but "" raises.

    A packet's count is the sum over its rays of each ray's own walk's
    count (``wide_trace_plain(counts=True)``): group tests are the groups
    whose 16 children a ray slab-tests, fires the leaf slots it
    narrowphases, and a ray's iterations are its group tests plus its
    fires, the port's serial units (one step of the lock-step loop, one
    leaf test). The reference counts one shared cursor a packet (its
    iterations are fired children plus pops of that cursor), so its
    numbers are of another unit. On the card this launches the kernel's
    counting build (a debug build, never timed), whose results are the
    timed build's bit for bit."""
    if exp:
        raise ValueError(f"the experimental walk {exp!r} is not ported")
    walk_wide = _choose_walk(scene, True)
    dev = resolve_device(device)
    r = rays.origin.shape[0]
    if r == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z, z
    rows = _count_rows(rays, packet, dev)
    sg = _start_g(scene, start_g, walk_wide, r, packet, dev)
    _, _, tests, fires = _launch_walk(scene, rows, True, start_g=sg,
                                      packet=packet, counts=True)
    tests, fires = packet_sums(tests, packet), packet_sums(fires, packet)
    return tests + fires, fires, tests


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
        return _no_hits(dev)
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
        return _no_hits(dev)
    with obs.span("trace_chained"):
        # row 6 of the ray rows is each part's bound
        rays_s, tm, rows = _prepare(rays, t_max, perm, dev)
        # the per-ray best raw t, each part's bound: +inf where t_max is not
        # finite, then only ever a finite hit t
        best_t = torch.where(torch.isfinite(tm), tm, _INF)
        best_loc = torch.zeros(r, dtype=torch.int64, device=dev)  # 0: -1 slot
        off = 1
        for part, ids in zip(chained.parts, chained.orig_ids):
            rows[6] = best_t
            gate = _part_root_gate(rows, _dev(part.smem_nodes, dev)[:6, 0],
                                   best_t, packet)
            t, lane_id = _walk(part, rows, packet, sweep, True, "closest",
                               _traces_wide(part), pre_gate=gate)
            t = torch.where(t < best_t, t, _INF)
            sid = _shape_ids(part, t, lane_id)
            closer = torch.isfinite(t) & (t < best_t)
            best_t = torch.where(closer, t, best_t)
            best_loc = torch.where(closer, sid.to(torch.int64) + off, best_loc)
            off += int(np.shape(ids)[0])
        with obs.span("epilogue"):
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
    with obs.span("trace_chained"):
        # row 6 of the ray rows is each part's bound
        _, tm0, rows = _prepare(rays, t_max, perm, dev)
        occ = torch.zeros(r, dtype=torch.bool, device=dev)
        for part in chained.parts:
            tm = torch.where(occ, 0.0, tm0)
            rows[6] = tm
            gate = _part_root_gate(rows, _dev(part.smem_nodes, dev)[:6, 0],
                                   tm, packet)
            t, _ = _walk(part, rows, packet, sweep, True, "any",
                         _traces_wide(part), pre_gate=gate)
            occ = occ | (t < tm)
        return occ
