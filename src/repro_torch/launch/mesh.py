"""Device meshes, the port of ``repro/launch/mesh.py``.

Defined as functions, so importing this module touches no process group.

  single-pod : (data=16, model=16)            — 256 ranks
  multi-pod  : (pod=2, data=16, model=16)     — 512 ranks; "pod" is the
               FL-silo axis

A mesh lives on the default process group, which the caller initialises
(``torch.distributed.init_process_group``: on one card NCCL with its
``device_id`` and a ``file://`` store, on the CPU gloo); its world size
must equal the mesh's size, and any other size raises.  The mesh is never
shrunk to fit.
"""
from __future__ import annotations

from typing import Dict, Tuple

_PRODUCTION = {False: (("data", 16), ("model", 16)),
               True: (("pod", 2), ("data", 16), ("model", 16))}


def production_mesh_shape(multi_pod: bool = False) -> Dict[str, int]:
    """The production mesh's axis sizes by name."""
    return dict(_PRODUCTION[bool(multi_pod)])


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    size = 1
    for n in shape:
        size *= n
    if not dist.is_initialized():
        raise RuntimeError(f"a {dict(zip(names, shape))} mesh needs the default process "
                           "group: call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {size} ranks; the "
                         f"process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) or (2, 16, 16) over a world of 256 or 512 ranks."""
    axes = _PRODUCTION[bool(multi_pod)]
    return _mesh(tuple(s for _, s in axes), tuple(n for n, _ in axes), device_type)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0, device_type: str = "cuda"):
    """A small ``("data", "model")`` mesh, or ``("pod", "data", "model")``
    when ``pod`` is set, over the default process group's ranks."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"), device_type)
    return _mesh((data, model), ("data", "model"), device_type)
