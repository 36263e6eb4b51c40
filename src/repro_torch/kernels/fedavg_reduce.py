"""Weighted FedAvg reduce over stacked client parameters.

The server's aggregation step reduces N client parameter vectors (the
flattened model, hundreds of MB at the paper's FEMNIST width) to their
weighted mean.  It is a pure streaming reduce, bound by device-memory
bytes: ``(N + 1) * L * itemsize`` for 2·N·L flops.

On a CUDA tensor :func:`fedavg_reduce` launches the hand-written Hopper
kernel in ``csrc/fedavg_reduce.cu`` (it replaces the Pallas TPU kernel
``repro/kernels/fedavg_reduce.py::_fedavg_kernel``; the source says how
it is built for the bound).  On a CPU tensor it computes the same
function with :func:`fedavg_reduce_plain`, and only there: a CUDA tensor
gets the kernel or an error, never the plain version.

``BLOCK`` is the reference's tile of 8192 elements.  The kernel needs no
tiles, but the port keeps the constant: :class:`~repro_torch.federated.
agg_engine.RavelPlan` pads each row of its ``(N, L)`` buffer to a multiple
of it, so every row starts 16-byte aligned for the kernel's vector loads.
"""
from __future__ import annotations

import ctypes

import torch

BLOCK = 8 * 128 * 8  # 8192 elements

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fedavg_reduce_plain(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``(x.float() * w[:, None]).sum(0)``.

    stacked (N, L) fp32/bf16, weights (N,) unnormalized -> (L,) in
    stacked's dtype, with fp32 accumulation."""
    w = weights.to(torch.float32)
    w = w / w.sum()
    return (stacked.float() * w[:, None]).sum(0).to(stacked.dtype)


def _check(stacked: torch.Tensor, weights: torch.Tensor) -> None:
    if stacked.dim() != 2:
        raise ValueError(f"expected an (N, L) buffer, got shape {tuple(stacked.shape)}")
    if stacked.dtype not in _DTYPE_CODES:
        raise TypeError(f"fedavg_reduce takes float32 or bfloat16, got {stacked.dtype}")
    if weights.dim() != 1 or weights.shape[0] != stacked.shape[0]:
        raise ValueError(
            f"weights of shape {tuple(weights.shape)} do not match "
            f"{stacked.shape[0]} stacked rows"
        )
    if weights.device != stacked.device:
        raise ValueError(f"weights on {weights.device}, buffer on {stacked.device}")


def _kernel_fn():
    """The C entry point, its argument types declared (64-bit pointers
    and stream; ctypes would otherwise pass them as 32-bit ints)."""
    from . import _build

    fn = _build.load("fedavg_reduce").fedavg_reduce_launch
    if not fn.argtypes:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _launch(stacked: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    n, L = stacked.shape
    if stacked.stride(1) != 1 and L > 1:
        raise ValueError("fedavg_reduce needs each row's columns contiguous (stride(1) == 1)")
    # Row stride in elements; with one row it multiplies only row 0.
    row_stride = stacked.stride(0) if n > 1 else -(-L // 8) * 8
    if n > 1 and row_stride < L:
        raise ValueError(f"row stride {row_stride} overlaps rows of length {L}")
    out = torch.empty(L, dtype=stacked.dtype, device=stacked.device)
    fn = _kernel_fn()
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream(stacked.device).cuda_stream
        err = fn(
            stacked.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, L, row_stride, _DTYPE_CODES[stacked.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"fedavg_reduce kernel launch failed: CUDA error {err}")
    fedavg_reduce.launches += 1
    return out


def fedavg_reduce(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted average over axis 0: (N, L) x (N,) -> (L,) in stacked's dtype.

    Weights are normalized to sum 1 in fp32 (as the reference does) and
    the sum is taken in fp32.  A CUDA buffer goes through the kernel,
    launched on the current stream without a synchronize; a CPU buffer
    through :func:`fedavg_reduce_plain`, and so does a ``meta`` buffer,
    for which it computes only the shape (the dry-run's)."""
    _check(stacked, weights)
    if stacked.device.type in ("cpu", "meta"):
        return fedavg_reduce_plain(stacked, weights)
    if stacked.device.type != "cuda":
        raise ValueError(f"fedavg_reduce runs on cuda, cpu or meta, not {stacked.device}")
    w = weights.to(torch.float32)
    w = (w / w.sum()).contiguous()
    if stacked.shape[1] == 0:
        return torch.empty(0, dtype=stacked.dtype, device=stacked.device)
    return _launch(stacked, w)


# Kernel launches since the count was last set to 0 (CPU and meta calls
# and empty buffers launch nothing and do not count).
fedavg_reduce.launches = 0  # type: ignore[attr-defined]
