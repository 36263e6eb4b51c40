"""Dispatch wrappers: one entry point per kernel, mirroring
``repro/kernels/ops.py``.

The reference picks Pallas-compiled or Pallas-interpreted by backend,
with an environment override.  The port has no such switch: each call
is routed by the device of the tensor it is given.  A CUDA tensor
launches the hand-written kernel (or raises); a CPU tensor runs the
plain PyTorch version.  A ``meta`` tensor (``launch/dryrun.py`` counts
steps on them) also takes the plain version of ``fedavg_reduce``,
``flash_attention``, ``ssd_scan`` and ``adamw_step``, which then computes
only shapes and launches nothing; ``dequant_fold`` is on no dry-run step
and takes no ``meta`` input.  Any other device raises.  There is no
override, and no fallback: a CUDA tensor never takes the plain version.
"""
from __future__ import annotations

from .adamw import adamw_step
from .dequant_fold import dequant_fold
from .fedavg_reduce import fedavg_reduce
from .flash_attention import flash_attention
from .ssd_scan import ssd_chunk_scan as ssd_scan

__all__ = ["adamw_step", "dequant_fold", "fedavg_reduce", "flash_attention", "ssd_scan"]
