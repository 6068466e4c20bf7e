"""Process groups and the ('rays', 'scene') device mesh on torch.distributed.

Counterpart of ``bvh_tpu/parallel/mesh.py``. One process drives one card
(``torchrun --nproc-per-node``: rank r on ``cuda:LOCAL_RANK``), so a mesh
of n devices is n ranks laid out as ``(n // scene_shards, scene_shards)``:
the scene axis is the inner one, ranks ``i * scene_shards ...`` of one
rays coordinate, within a host when ``scene_shards`` divides the ranks a
host runs. A rank's rays coordinate is ``rank // scene_shards``. The
collectives are NCCL's on the card and gloo's on the CPU; the traversal
itself has none.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device

AXES = ("rays", "scene")

# the variables a launcher (torchrun) sets for init_method="env://"
_CLUSTER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _backend(device) -> str:
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def _local_device(device) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (made current, as NCCL
    needs it), or the CPU when ``device`` says so."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    return dev


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> int:
    """Joins this process to the job's process group (call once per
    process, before the first mesh). Returns the world size.

    ``coordinator_address`` ("host:port") with ``num_processes`` and
    ``process_id`` names the group explicitly (``tcp://``); without it a
    launcher's environment (``torchrun``: MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK) is read. With neither, there is no cluster: nothing
    is created and 1 is returned (a world of one; ``make_mesh`` then makes
    its own single-rank group). A second call returns the world size. The
    backend is NCCL (each rank on its card, ``cuda:LOCAL_RANK``) unless
    ``backend`` names another: gloo for ranks on the CPU. Any other failure
    raises."""
    if dist.is_initialized():
        return dist.get_world_size()
    if coordinator_address is None:
        if not all(k in os.environ for k in _CLUSTER_ENV):
            return 1
        init, kw = "env://", {}
    else:
        init = f"tcp://{coordinator_address}"
        kw = {"world_size": num_processes, "rank": process_id}
    backend = backend or _backend(None)
    if backend == "nccl":
        _local_device(None)
    dist.init_process_group(backend, init_method=init, **kw)
    return dist.get_world_size()


def ensure_group(device=None) -> int:
    """Creates a single-rank group over an in-process store where this
    process has none (no network, no environment); returns the world
    size."""
    if not dist.is_initialized():
        dist.init_process_group(_backend(device), store=dist.HashStore(),
                                world_size=1, rank=0)
    return dist.get_world_size()


# the meshes made over the current default group, by (n, scene_shards,
# device type): each DeviceMesh makes a communicator per axis, which
# nothing frees until the group is destroyed
_meshes: dict = {}
_meshes_world = None


def make_mesh(n_devices: int | None = None, scene_shards: int = 1,
              device=None) -> DeviceMesh:
    """A ('rays', 'scene') mesh over ranks ``0 .. n_devices - 1`` (None:
    the whole world), ``scene_shards`` of them along the scene (primitive
    range) axis, the rest along the rays (data-parallel) axis. Every rank
    of the world calls it (the axes' groups are made collectively); a rank
    outside the mesh takes no part in its calls. ``device``: the ranks'
    devices, the card (None, ``cuda:LOCAL_RANK``) or ``"cpu"``. A second
    call with the same arguments over the same group returns the same
    mesh."""
    global _meshes_world
    world = ensure_group(device)
    n = n_devices or world
    if n % scene_shards:
        raise ValueError(
            f"{n} devices not divisible by scene_shards={scene_shards}")
    if n > world:
        raise ValueError(f"{n} devices asked for, but the world has {world}")
    dev = _local_device(device)
    if _meshes_world is not dist.group.WORLD:
        _meshes.clear()
        _meshes_world = dist.group.WORLD
    key = (n, scene_shards, dev.type)
    if key not in _meshes:
        ranks = torch.arange(n, dtype=torch.int32).reshape(
            n // scene_shards, scene_shards)
        _meshes[key] = DeviceMesh(dev.type, ranks, mesh_dim_names=AXES)
    return _meshes[key]


def make_multihost_mesh(scene_shards: int = 1, device=None) -> DeviceMesh:
    """A ('rays', 'scene') mesh over every rank of every process: with one
    card a process and a launcher's rank order (host-major), the scene
    axis stays within a host and the rays axis spans hosts, so only the
    training step's gradient sums cross them. Call ``init_distributed()``
    first on every host."""
    return make_mesh(None, scene_shards=scene_shards, device=device)


def axis(mesh: DeviceMesh, name: str):
    """``(size, coordinate, group)`` of this rank on the mesh's axis
    ``name``."""
    return (mesh.size(AXES.index(name)), mesh.get_local_rank(name),
            mesh.get_group(name))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's work and collectives run on."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` of one shape stacked in group-rank order along a
    new leading axis."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)
