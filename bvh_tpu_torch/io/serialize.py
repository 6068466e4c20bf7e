"""Saving and loading the acceleration structures: one compressed npz a
structure, in the JAX package's format (``bvh_tpu/io/serialize.py``): the
same keys and versions, so that either package reads what the other
writes.

Writers take host or device structures; tensors are written through the
host. Loaders return host (numpy) tables, as the port's host builds hold
them; the trace entry points copy them to the card at first use.

The exact-frame table ``a_lo`` that every scene the port builds carries
(``TightScene.a_lo``, ``ClusterScene.a_lo``) is written under an extra key,
``a_lo`` (``p{i}_a_lo`` for chained parts), which the JAX package's
loaders, reading keys by name, ignore. A file without it (the JAX
package's) loads with zeros there (``scene_from_arrays``,
``cluster_scene_from_arrays``), so that its scenes too are traced in the
exact cluster frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bvh.flat import FlatBvh
from ..ops.cluster import (CLUSTER_VERSION, TIGHT_VERSION, ChainedScene,
                           ClusterScene, TightScene, chained_scene_from_parts,
                           cluster_scene_from_arrays, scene_from_arrays)

_BVH_VERSION = 1  # ``__version__`` of a FlatBvh file
_CHAINED_VERSION = 1  # ``__chained_version__``

# a TightScene's optional tables, written where they are not None
_TIGHT_OPTIONAL = ("bgroups", "sweep_nodes", "packed_nodes", "gnodes",
                   "gslot")


def _host(x) -> np.ndarray:
    """An array or tensor as a numpy array (through the host)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _check_version(z, key: str, newest: int, what: str) -> None:
    version = int(z[key])
    if version > newest:
        raise ValueError(f"{what} file version {version} is newer than "
                         f"supported ({newest})")


def save_bvh(path: str, flat: FlatBvh, shape_to_node=None) -> None:
    """Writes a ``FlatBvh`` (and its shape -> leaf map, if given)."""
    f = flat.to_host()
    payload = {name: getattr(f, name) for name in FlatBvh._fields}
    payload["__version__"] = np.int64(_BVH_VERSION)
    if shape_to_node is not None:
        payload["shape_to_node"] = _host(shape_to_node)
    np.savez_compressed(path, **payload)


def load_bvh(path: str):
    """Returns ``(FlatBvh, shape_to_node or None)``, numpy."""
    with np.load(path) as z:
        _check_version(z, "__version__", _BVH_VERSION, "bvh")
        flat = FlatBvh(*(z[name] for name in FlatBvh._fields))
        s2n = z["shape_to_node"] if "shape_to_node" in z.files else None
    return flat, s2n


def save_cluster_scene(path: str, scene: ClusterScene) -> None:
    """Writes a legacy ``ClusterScene``, its ``a_lo`` included."""
    np.savez_compressed(
        path,
        __version__=np.int64(CLUSTER_VERSION),
        smem_nodes=_host(scene.smem_nodes),
        smem_cc=_host(scene.smem_cc),
        tris_rel=_host(scene.tris_rel),
        tri_map=_host(scene.tri_map),
        num_clusters=np.int64(scene.num_clusters),
        num_nodes=np.int64(scene.num_nodes),
        relative=np.bool_(scene.relative),
        a_lo=_host(scene.a_lo),
    )


def load_cluster_scene(path: str) -> ClusterScene:
    """A ``ClusterScene`` from a file either package wrote (its version is
    checked by ``cluster_scene_from_arrays``)."""
    with np.load(path) as z:
        return cluster_scene_from_arrays({k: z[k] for k in z.files})


def _tight_payload(scene, prefix: str = "") -> dict:
    """A TightScene's keys (each under ``prefix``): the tables, the counts
    and width as 0-d int64, the optional tables that are set (``gdepth``
    with ``gnodes``), ``masked`` (1, only where set) and ``a_lo``."""
    out = {"smem_nodes": _host(scene.smem_nodes),
           "groups": _host(scene.groups),
           "tri_map": _host(scene.tri_map),
           "num_clusters": np.int64(scene.num_clusters),
           "num_nodes": np.int64(scene.num_nodes),
           "width": np.int64(scene.width)}
    for name in _TIGHT_OPTIONAL:
        v = getattr(scene, name)
        if v is not None:
            out[name] = _host(v)
    if scene.gnodes is not None:
        out["gdepth"] = np.int64(scene.gdepth)
    if bool(scene.masked):
        out["masked"] = np.int64(1)
    if scene.a_lo is not None:
        out["a_lo"] = _host(scene.a_lo)
    return {prefix + k: v for k, v in out.items()}


def save_tight_scene(path: str, scene: TightScene) -> None:
    """Writes a ``TightScene``, its ``a_lo`` included."""
    np.savez_compressed(path, __tight_version__=np.int64(TIGHT_VERSION),
                        **_tight_payload(scene))


def load_tight_scene(path: str) -> TightScene:
    """A ``TightScene`` from a file either package wrote (numpy tables; its
    version is checked by ``scene_from_arrays``)."""
    with np.load(path) as z:
        return scene_from_arrays({k: z[k] for k in z.files})


def save_chained_scene(path: str, chained: ChainedScene) -> None:
    """Writes a ``ChainedScene``: every part's TightScene keys under
    ``p{i}_`` and its part-local -> global triangle ids ``p{i}_orig_ids``."""
    payload = {"__chained_version__": np.int64(_CHAINED_VERSION),
               "n_parts": np.int64(len(chained.parts))}
    for i, (part, ids) in enumerate(zip(chained.parts, chained.orig_ids)):
        payload.update(_tight_payload(part, f"p{i}_"))
        payload[f"p{i}_gdepth"] = np.int64(part.gdepth)
        payload[f"p{i}_orig_ids"] = _host(ids)
    np.savez_compressed(path, **payload)


def load_chained_scene(path: str) -> ChainedScene:
    """A ``ChainedScene`` from a file either package wrote (numpy tables)."""
    with np.load(path) as z:
        _check_version(z, "__chained_version__", _CHAINED_VERSION,
                       "chained scene")
        parts, ids = [], []
        for i in range(int(z["n_parts"])):
            parts.append({name: z[f"p{i}_{name}"]
                          for name in TightScene._fields
                          if f"p{i}_{name}" in z.files})
            ids.append(z[f"p{i}_orig_ids"])
    return chained_scene_from_parts(parts, ids)
