"""Ray-sharded closest-hit and any-hit traces over a replicated scene.

Counterpart of ``bvh_tpu/parallel/tight.py``. Every rank holds the whole
``TightScene`` (a few MB of tables) and traces its chunk of the rays with
the port's kernels (``ops/trace.py``: the group walk, ``wide_trace.cu``,
or the entry/exit walk, ``tight_trace.cu``, each in its FRAME build on a
scene that carries ``a_lo``); the only collective is the all_gather of
the results over the rays axis. Ranks that differ only in their scene
coordinate trace the same chunk. The walks are per ray, so the results
are the unsharded trace's bit for bit.
"""

from __future__ import annotations

import torch

from ..bvh.traverse import HitRecord
from ..ops.trace import trace_any_hit_tight, trace_closest_hit_tight
from ..ray import Ray
from .mesh import axis, gather, mesh_device

PARK_ORIGIN = 2.0e30  # a padding ray's origin (direction 1): it hits nothing


def _chunk(mesh, rays: Ray, t_max, packet: int):
    """This rank's chunk of the global rays, as the reference pads them: a
    multiple of ``packet`` per rank, parked rays (origin 2e30, direction
    1) after the last, t_max (given) padded with +inf. Returns the chunk's
    rays and t_max on the rank's device, and the rays axis' group."""
    n_ax, i, group = axis(mesh, "rays")
    dev = mesh_device(mesh)
    r = rays.origin.shape[0]
    chunk = -(-r // n_ax)
    chunk = -(-chunk // packet) * packet
    lo, hi = min(i * chunk, r), min((i + 1) * chunk, r)
    pad = chunk - (hi - lo)

    def part(x, fill):
        x = torch.as_tensor(x, device=dev)[lo:hi]
        if not pad:
            return x
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=dev)])

    local = Ray(part(rays.origin, PARK_ORIGIN), part(rays.direction, 1.0),
                part(rays.inv_direction, 1.0))
    tm = None
    if t_max is not None:
        tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
        tm = part(tm.reshape(-1).expand(r), float("inf"))
    return local, tm, group


def sharded_trace_closest_hit(mesh, scene, rays: Ray, tris=None,
                              packet: int = 2048, t_max=None) -> HitRecord:
    """Closest hit of a ray batch sharded over ``mesh``'s rays axis.

    ``scene`` is a TightScene (host- or device-built) and ``rays`` the
    global batch, the same on every rank of the mesh; each rank returns the
    whole ``HitRecord`` on its device. Same contract as
    ``trace_closest_hit_tight`` (``tris``: the exact winner recompute;
    ``t_max``: scalar or [n] bound). The ray count is padded to ranks x
    packet internally."""
    r = rays.origin.shape[0]
    if r == 0:
        z = torch.zeros(0, dtype=torch.float32, device=mesh_device(mesh))
        return HitRecord(z, z, z, torch.zeros(0, dtype=torch.int32,
                                              device=z.device))
    local, tm, group = _chunk(mesh, rays, t_max, packet)
    hit = trace_closest_hit_tight(scene, local, tris=tris, packet=packet,
                                  t_max=tm, device=local.origin.device)
    # one collective for the four fields: float32 rows, the ids' bits
    # viewed as floats and back (moved, never converted)
    rows = torch.stack([hit.t, hit.u, hit.v,
                        hit.shape_id.view(torch.float32)])
    rows = gather(rows, group).transpose(0, 1).reshape(4, -1)[:, :r]
    return HitRecord(rows[0], rows[1], rows[2],
                     rows[3].contiguous().view(torch.int32))


def sharded_trace_any_hit(mesh, scene, rays: Ray, t_max=None,
                          packet: int = 2048) -> torch.Tensor:
    """Occlusion query sharded over ``mesh``'s rays axis (shadow rays):
    bool [n] on every rank, as ``trace_any_hit_tight``."""
    r = rays.origin.shape[0]
    if r == 0:
        return torch.zeros(0, dtype=torch.bool, device=mesh_device(mesh))
    local, tm, group = _chunk(mesh, rays, t_max, packet)
    occ = trace_any_hit_tight(scene, local, t_max=tm, packet=packet,
                              device=local.origin.device)
    return gather(occ, group).reshape(-1)[:r]


def multihost_trace_closest_hit(mesh, scene, local_rays: Ray,
                                packet: int = 2048) -> HitRecord:
    """Closest hit on a multi-process mesh: each rank passes only its own
    shard of the global batch (``local_rays``) and gets back the hits of
    that shard, as tensors on its device. The local ray count must be a
    multiple of ``packet`` and the same on every rank of the world (one
    small all_gather of the counts checks it)."""
    dev = mesh_device(mesh)
    r_local = local_rays.origin.shape[0]
    # every rank checks every count, so that all raise together
    counts = gather(torch.tensor([r_local], device=dev), None).reshape(-1)
    if r_local % packet:
        raise ValueError(
            f"local ray count {r_local} must be a multiple of packet x "
            f"local rays-axis devices = {packet} x 1 (pad with parked "
            "rays: origin 2e30, direction 1)")
    if bool((counts != r_local).any()) or bool((counts % packet).any()):
        raise ValueError("local ray counts differ across ranks: "
                         f"{counts.tolist()}")
    rays = Ray(*(torch.as_tensor(x, device=dev) for x in local_rays))
    return trace_closest_hit_tight(scene, rays, packet=packet, device=dev)
