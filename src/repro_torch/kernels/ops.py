"""Dispatch wrappers: one entry point per kernel, mirroring
``repro/kernels/ops.py``.

The reference picks Pallas-compiled or Pallas-interpreted by backend,
with an environment override.  The port has no such switch: each call
is routed by the device of the tensor it is given.  A CUDA tensor
launches the hand-written kernel (or raises); a CPU tensor runs the
plain PyTorch version.  There is no override and no fallback.
"""
from __future__ import annotations

from .dequant_fold import dequant_fold
from .fedavg_reduce import fedavg_reduce

__all__ = ["dequant_fold", "fedavg_reduce"]
