"""Hand-written Hopper kernels for the port, one per Pallas TPU kernel of
the reference:

  fedavg_reduce   — the server's aggregation reduce
                    (csrc/fedavg_reduce.cu, CUDA C++ for sm_90a);
  dequant_fold    — the compressed round's fused dequantize-and-fold
                    (csrc/dequant_fold.cu, CUDA C++ for sm_90a);
  flash_attention — causal / windowed GQA attention of the zoo's prefill
                    (csrc/flash_attention.cu, CUDA C++ for sm_90a);
  ssd_scan        — Mamba-2's SSD intra-chunk scan of the zoo's prefill
                    (csrc/ssd_scan.cu, CUDA C++ for sm_90a).

``ops`` routes each call by its tensor's device; ``ref`` holds the plain
oracles; ``_build`` compiles the CUDA sources with nvcc at first use.
"""
from .ops import dequant_fold, fedavg_reduce, flash_attention, ssd_scan

__all__ = ["dequant_fold", "fedavg_reduce", "flash_attention", "ssd_scan"]
