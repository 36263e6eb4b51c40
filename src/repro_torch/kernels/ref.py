"""Plain PyTorch oracles for the port's kernels (the ground truth tests
hold each kernel against), mirroring ``repro/kernels/ref.py``.

  fedavg_reduce_ref       <- kernels/fedavg_reduce.py
  dequant_fold_ref        <- kernels/dequant_fold.py
  flash_attention_ref     <- kernels/flash_attention.py (models.layers
                             causal_attention / full_attention)
  ssd_scan_ref            <- kernels/ssd_scan.py (models.mamba2.ssd_chunked)
  ssd_scan_sequential_ref <- models.mamba2.ssd_reference, the O(L)
                             recurrence
"""
from __future__ import annotations

from .dequant_fold import dequant_fold_plain as dequant_fold_ref
from .fedavg_reduce import fedavg_reduce_plain as fedavg_reduce_ref
from .flash_attention import flash_attention_plain as flash_attention_ref
from .ssd_scan import ssd_chunk_scan_plain as ssd_scan_ref


def ssd_scan_sequential_ref(x, dt, A, B_mat, C_mat, initial_state=None):
    """The O(L) recurrent gold standard (slowest, exact semantics)."""
    from ..models.mamba2 import ssd_reference

    return ssd_reference(x, dt, A, B_mat, C_mat, initial_state)


__all__ = ["dequant_fold_ref", "fedavg_reduce_ref", "flash_attention_ref", "ssd_scan_ref",
           "ssd_scan_sequential_ref"]
