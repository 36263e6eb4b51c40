"""Hand-written Hopper kernels for the port, one per Pallas TPU kernel of
the reference:

  fedavg_reduce   — the server's aggregation reduce
                    (csrc/fedavg_reduce.cu, CUDA C++ for sm_90a);
  dequant_fold    — the compressed round's fused dequantize-and-fold
                    (csrc/dequant_fold.cu, CUDA C++ for sm_90a);
  flash_attention — causal / windowed GQA attention of the zoo's prefill
                    (csrc/flash_attention.cu, CUDA C++ for sm_90a);
  ssd_scan        — Mamba-2's SSD intra-chunk scan of the zoo's prefill
                    (csrc/ssd_scan.cu, CUDA C++ for sm_90a);

and one that replaces no TPU kernel (the reference's AdamW is jnp code),
added because the unfused update was bound by bytes it need not move:

  adamw_step      — AdamW's update over a step's leaves in one pass
                    (csrc/adamw_step.cu, CUDA C++ for sm_90a).

``ops`` routes each call by its tensor's device; ``ref`` holds the plain
oracles; ``_build`` compiles the CUDA sources with nvcc at first use.
"""
from .ops import adamw_step, dequant_fold, fedavg_reduce, flash_attention, ssd_scan

__all__ = ["adamw_step", "dequant_fold", "fedavg_reduce", "flash_attention", "ssd_scan"]
