"""Causal or full GQA flash attention, forward only, with an optional
sliding window.

Every attention layer of the zoo's prefill (``ModelFamily.prefill``)
calls it once: at olmo-1b's prefill (B = 4, S = 2048, 16 heads of 128,
bf16, causal) that is 68.7 GFLOP of the two products against 134 MB of
q, k, v and output, so it is bound by the tensor cores' operations, not
by device-memory bytes.

On a CUDA tensor :func:`flash_attention` launches the hand-written Hopper
kernel in ``csrc/flash_attention.cu`` (it replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel``; the source says how
it is built).  On a CPU tensor it computes the same function with
:func:`flash_attention_plain`, the port's ``causal_attention`` (or
``full_attention`` when ``causal=False``), and only there: a CUDA tensor
gets the kernel or an error, never the plain version.

The contract is the reference's: q ``(B, S, H, D)``, k and v
``(B, S, KV, D)`` with ``H % KV == 0``, fp32 or bf16, the output in q's
dtype; query head ``h`` reads KV head ``h // (H // KV)``; the scale is
``1/sqrt(D)``; queries and keys share positions ``0..S-1``.  One thing
is wider: S need not be a multiple of a block (the reference asserts it
is); the kernel masks the ragged edge itself.  Rows with no key in range
give 0.  fp32 inputs run on the CUDA cores in fp32; bf16 inputs on the
tensor cores with fp32 accumulation and an fp32 online softmax, the
probabilities rounded to bf16 for the product with V (unnormalized,
where ``causal_attention`` rounds the normalized weights), so bf16
results agree to the reference's bf16 tolerance (2e-2), not bit for bit.

No backward exists, in the reference or here: a CUDA input that needs a
gradient while grad mode is on raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)  # the kernel is instantiated for these head widths


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version: the reference oracle's
    ``flash_attention_ref``, i.e. ``causal_attention`` (with the window)
    or ``full_attention``."""
    from ..models.layers import causal_attention, full_attention

    if causal:
        return causal_attention(q, k, v, sliding_window=window)
    if window is not None:
        raise ValueError("a sliding window implies causal attention")
    return full_attention(q, k, v)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected (B, S, H, D) tensors, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of {k.shape[2]} KV heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if window is not None and (not causal or window < 1):
        raise ValueError(f"window {window} needs causal attention and a width >= 1")


def _kernel_fn():
    """The C entry point, its argument types declared (64-bit pointers,
    strides and stream)."""
    from . import _build

    fn = _build.load("flash_attention").flash_attention_launch
    if not fn.argtypes:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _rows_aligned(t: torch.Tensor) -> bool:
    """D contiguous, and every row starting on 16 bytes: the bf16 kernel
    copies its tiles 16 bytes at a time."""
    per16 = 16 // t.element_size()
    return (t.stride(-1) == 1 and all(st % per16 == 0 for st in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int]) -> torch.Tensor:
    B, S, H, D = q.shape
    KV = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel is built for head widths {HEAD_DIMS}, "
                         f"got {D}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward (neither has the reference's Pallas kernel); "
            "training through it comes with ROADMAP.md queue 1, item 17 (training the zoo)")
    q, k, v = (t if _rows_aligned(t) else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, KV, D,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 int(causal), 0 if window is None else int(window),
                 1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Attention of q ``(B, S, H, D)`` over k, v ``(B, S, KV, D)``; returns
    ``(B, S, H, D)`` in q's dtype.  A CUDA call goes through the kernel,
    launched on the current stream without a synchronize; a CPU call
    through :func:`flash_attention_plain`."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.numel() == 0:
        return torch.zeros_like(q)
    return _launch(q, k, v, causal, window)


# Kernel launches since the count was last set to 0 (CPU calls and empty
# inputs launch nothing and do not count).
flash_attention.launches = 0  # type: ignore[attr-defined]
