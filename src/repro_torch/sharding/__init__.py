"""Sharding rules and the compute-mesh context, the port of
``repro.sharding``."""
from .context import axis_sizes, compute_mesh, current_compute_mesh
from .rules import (
    PartitionSpec,
    batch_specs,
    cache_specs,
    compute_specs,
    decode_token_spec,
    distribute,
    param_specs,
    to_named,
)

__all__ = ["PartitionSpec", "axis_sizes", "batch_specs", "cache_specs", "compute_mesh",
           "compute_specs", "current_compute_mesh", "decode_token_spec", "distribute",
           "param_specs", "to_named"]
