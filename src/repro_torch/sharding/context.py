"""Compute-mesh context, the port of ``repro/sharding/context.py``.

A launcher sets the mesh before it runs a step; model code that is
otherwise sharding-agnostic reads it (``models/moe.py`` takes its group
count from the mesh's "data" axis, ``models/layers.scan_layers`` looks
for FSDP / sequence-parallel settings).  No context (tests, one-card
runs) -> ``current_compute_mesh()`` is ``None``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or any object
whose axis sizes can be read by name (``axis_sizes``): the rules only
ever read sizes, so a shape-only stand-in serves for planning.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional

_state = threading.local()


def current_compute_mesh() -> Optional[Any]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def compute_mesh(mesh: Optional[Any]):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}``: ``zip(mesh.mesh_dim_names, mesh.shape)`` for a
    ``DeviceMesh``, ``mesh.shape`` itself for a stand-in whose ``shape`` is
    already a mapping (the reference's ``Mesh.shape`` is one)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {str(n): int(s) for n, s in zip(names, mesh.shape)}
    return {str(n): int(s) for n, s in dict(mesh.shape).items()}
