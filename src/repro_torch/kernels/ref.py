"""Plain PyTorch oracles for the port's kernels (the ground truth tests
hold each kernel against), mirroring ``repro/kernels/ref.py``.

  fedavg_reduce_ref <- kernels/fedavg_reduce.py
  dequant_fold_ref  <- kernels/dequant_fold.py

The other two oracles of the reference (flash attention, the SSD scan)
arrive with their kernels in the model-zoo slice.
"""
from __future__ import annotations

from .dequant_fold import dequant_fold_plain as dequant_fold_ref
from .fedavg_reduce import fedavg_reduce_plain as fedavg_reduce_ref

__all__ = ["dequant_fold_ref", "fedavg_reduce_ref"]
