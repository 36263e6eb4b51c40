"""NVIDIA H100 SXM5 80GB constants (one card) — the roofline denominators.

Source: NVIDIA's H100 data sheet,
https://www.nvidia.com/en-us/data-center/h100/ (H100 SXM column; the
tensor-core rates there are quoted with sparsity, and the dense rates
below are half of them), and for shared memory the Hopper tuning guide,
https://docs.nvidia.com/cuda/hopper-tuning-guide/.  The names follow the
reference's table where the meaning carries over.
"""

PEAK_FLOPS_BF16 = 989e12    # bf16 / fp16 tensor cores, dense (1,979 TFLOP/s with sparsity)
PEAK_FLOPS_TF32 = 495e12    # tf32 tensor cores, dense (989 TFLOP/s with sparsity)
PEAK_FLOPS_FP32 = 67e12     # fp32 outside the tensor cores
HBM_BANDWIDTH = 3.35e12     # HBM3, 3.35 TB/s
HBM_BYTES = 80e9            # the data sheet's 80 GB
# The total that torch.cuda.mem_get_info reports on an H100 80GB HBM3
# (chip_smoke.py prints it and checks it against this value).
HBM_BYTES_VISIBLE = 79.18 * 2**30
# NVLink 4: the data sheet's 900 GB/s counts both directions of all 18
# links of one card; one direction, all links together, is half of it.
ICI_LINK_BANDWIDTH = 450e9
SMEM_BYTES_PER_SM = 228 * 1024   # shared memory per SM (227 KiB of it for one block)
