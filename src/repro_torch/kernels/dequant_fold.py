"""Fused dequantize-and-fold of one compressed client update.

A compressed round folds each client's int8 or fp16 delta straight into
the server's fp32 accumulator: ``acc += (w * scales[block]) * data``, one
pass over the quantized bytes, with no dense fp32 copy of the update.
At the paper's FEMNIST width that is 164 MB of int8 codes (328 MB of
fp16) against a 657 MB accumulator, read and written once: bound by
device-memory bytes.

On a CUDA tensor :func:`dequant_fold` launches the hand-written Hopper
kernel in ``csrc/dequant_fold.cu`` (it replaces the Pallas TPU kernel
``repro/kernels/fedavg_reduce.py::_dequant_fold_kernel``; the source says
how it is built for the bound).  On a CPU tensor it computes the same
function with :func:`dequant_fold_plain`, and only there: a CUDA tensor
gets the kernel or an error, never the plain version.

The contract is the reference's: ``acc`` is fp32 with a length that is a
multiple of ``BLOCK`` = 8192 (``ValueError`` naming BLOCK otherwise), it
is updated in place and returned, int8 payloads carry one fp32 scale per
8192-element block and fp16 payloads take unit scales.  One thing is
wider: the payload may be shorter than ``acc`` (the wire payload is
``total_elems`` long; the reference pads it with zeros on the host every
fold).  The accumulator's elements past the payload are left as they are.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .fedavg_reduce import BLOCK

_CODE_OF = {torch.int8: 0, torch.float16: 1}


def f32_scalar(x) -> float:
    """``x`` rounded to fp32, as a Python float: any product of an fp32
    tensor with it is then the one fp32-rounded product the kernel forms
    (the reference's ``jnp.float32(x)``)."""
    return float(np.float32(float(x)))


def dequant_fold_plain(acc: torch.Tensor, data: torch.Tensor, scales: torch.Tensor,
                       weight) -> torch.Tensor:
    """The plain PyTorch version, the reference's
    ``_flat_dequant_fold_jnp_impl`` on the payload's blocks:
    ``acc.view(nb, 8192).add_((w * scales)[:, None] * data.view(nb, 8192).float())``,
    with the payload's ragged last block folded on its own.  In place;
    returns ``acc``."""
    n = data.numel()
    ws = scales.float() * f32_scalar(weight)
    full = n // BLOCK
    head = full * BLOCK
    if full:
        acc[:head].view(full, BLOCK).add_(ws[:full, None] * data[:head].view(full, BLOCK).float())
    if n > head:
        acc[head:n].add_(ws[full] * data[head:n].float())
    return acc


def _check(acc: torch.Tensor, data: torch.Tensor, scales: torch.Tensor) -> None:
    if acc.dim() != 1 or acc.dtype != torch.float32:
        raise TypeError(f"accumulator must be a 1-D float32 tensor, got {acc.dtype} "
                        f"of shape {tuple(acc.shape)}")
    lp = acc.shape[0]
    if lp % BLOCK:
        raise ValueError(f"accumulator length {lp} not a multiple of BLOCK={BLOCK}")
    if data.dtype not in _CODE_OF:
        raise TypeError(f"dequant_fold takes int8 or float16 payloads, got {data.dtype}")
    if data.dim() != 1 or data.shape[0] > lp:
        raise ValueError(f"payload of shape {tuple(data.shape)} does not fit an "
                         f"accumulator of {lp}")
    nb = lp // BLOCK
    if scales.dim() != 1 or scales.shape[0] != nb:
        raise ValueError(f"scales of shape {tuple(scales.shape)}; expected ({nb},)")
    if not (acc.device == data.device == scales.device):
        raise ValueError(f"accumulator on {acc.device}, payload on {data.device}, "
                         f"scales on {scales.device}")


def _kernel_fn():
    """The C entry point with its argument types declared (64-bit
    pointers and stream, an fp32 weight)."""
    from . import _build

    fn = _build.load("dequant_fold").dequant_fold_launch
    if not fn.argtypes:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _launch(acc: torch.Tensor, data: torch.Tensor, scales: torch.Tensor, w: float) -> None:
    if not (acc.is_contiguous() and data.is_contiguous()):
        raise ValueError("dequant_fold needs a contiguous accumulator and payload")
    scales = scales.to(torch.float32).contiguous()
    fn = _kernel_fn()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = fn(acc.data_ptr(), data.data_ptr(), scales.data_ptr(), w,
                 data.numel(), _CODE_OF[data.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dequant_fold kernel launch failed: CUDA error {err}")
    dequant_fold.launches += 1


def dequant_fold(acc: torch.Tensor, data: torch.Tensor, scales: torch.Tensor,
                 weight) -> torch.Tensor:
    """``acc[:n] += (w * scales[i // 8192]) * data`` in place; returns ``acc``.

    ``acc`` (Lp,) fp32 with Lp % 8192 == 0; ``data`` (n,) int8 or fp16,
    n <= Lp; ``scales`` (Lp // 8192,) fp32; ``weight`` a scalar, rounded
    to fp32.  A CUDA accumulator goes through the kernel, launched on the
    current stream without a synchronize; a CPU one through
    :func:`dequant_fold_plain`."""
    _check(acc, data, scales)
    if acc.device.type == "cpu":
        return dequant_fold_plain(acc, data, scales, weight)
    if acc.device.type != "cuda":
        raise ValueError(f"dequant_fold runs on cuda or cpu, not {acc.device}")
    if data.numel():
        _launch(acc, data, scales, f32_scalar(weight))
    return acc


# Kernel launches since the count was last set to 0 (CPU calls and empty
# payloads launch nothing and do not count).
dequant_fold.launches = 0  # type: ignore[attr-defined]
