"""Causal or full GQA flash attention, with an optional sliding window,
and its gradient.

Every attention layer of the zoo's prefill (``ModelFamily.prefill``)
calls it once: at olmo-1b's prefill (B = 4, S = 2048, 16 heads of 128,
bf16, causal) that is 68.7 GFLOP of the two products against 134 MB of
q, k, v and output, so it is bound by the tensor cores' operations, not
by device-memory bytes.

On a CUDA tensor :func:`flash_attention` launches the hand-written Hopper
kernel in ``csrc/flash_attention.cu`` (it replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel``).  For bf16 it is a
warp-specialised wgmma kernel: a producer warpgroup keeps TMA loads of
128-key K and V tiles in flight through a two-stage ring of swizzled
shared memory, and two consumer warpgroups of 64 query rows each form
S = Q K^T and O += P V with ``wgmma`` (P from registers); fp32 runs on
the CUDA cores.  What holds the bf16 kernel back now is that a
consumer's softmax does not overlap the products (no ping-pong, no
intra-warpgroup overlap) and blocks are not persistent; the source says
more.  On a CPU tensor it computes the same function with
:func:`flash_attention_plain`, the port's ``causal_attention`` (or
``full_attention`` when ``causal=False``), and only there: a CUDA tensor
gets the kernel or an error, never the plain version.

The contract is the reference's: q ``(B, S, H, D)``, k and v
``(B, S, KV, D)`` with ``H % KV == 0``, fp32 or bf16, the output in q's
dtype; query head ``h`` reads KV head ``h // (H // KV)``; the scale is
``1/sqrt(D)``; queries and keys share positions ``0..S-1``.  One thing
is wider: S need not be a multiple of a block (the reference asserts it
is); the kernel masks the ragged edge itself (TMA fills keys past S with
zeros).  The bf16 path needs q, k and v on 16-byte bases and strides,
which TMA addresses; the wrapper copies a tensor that is not.  Rows with
no key in range give 0.  fp32 inputs run on the CUDA cores in fp32; bf16
inputs on the tensor cores with fp32 accumulation and an fp32 online
softmax (in base 2), the
probabilities rounded to bf16 for the product with V (unnormalized,
where ``causal_attention`` rounds the normalized weights), so bf16
results agree to the reference's bf16 tolerance (2e-2), not bit for bit.

The gradient.  The reference has no backward kernel: the JAX package
differentiates the plain ``causal_attention`` / ``full_attention`` with
autodiff.  Here a CUDA call that needs a gradient goes through
:class:`_FlashAttentionFn`: its forward is the kernel with the row
log-sum-exp stored as well (fp32 ``(B, H, S)``), and its backward is the
hand-written kernel in ``csrc/flash_attention_bwd.cu`` behind
:func:`flash_attention_bwd` (the same contract as the forward: causal or
full, window, GQA, D 64 or 128, fp32 or bf16, ragged S), never autograd
through the plain version.  :func:`flash_attention_bwd_plain` is that
gradient in closed form, the kernel's plain version.  A call without a
gradient (the prefill) stores no log-sum-exp.  A CPU call differentiates
through :func:`flash_attention_plain`, as the reference does.
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
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _rows_aligned(t: torch.Tensor) -> bool:
    """D contiguous, the base on 16 bytes and every other stride a positive
    multiple of 16 bytes: the bf16 kernel reads its tiles with TMA, which
    addresses nothing else (its launcher refuses such a tensor)."""
    per16 = 16 // t.element_size()
    return (t.stride(-1) == 1 and all(st > 0 and st % per16 == 0 for st in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _as_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel can read it, else a fresh contiguous
    copy (``contiguous()`` would hand back a contiguous tensor whose base is
    off 16 bytes as it is)."""
    return t if _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)


def _check_head_dim(D: int) -> None:
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernels are built for head widths {HEAD_DIMS}, "
                         f"got {D}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel on aligned q, k, v; with ``lse`` (fp32 ``(B, H,
    S)``) it also stores the row log-sum-exp there."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    _check_head_dim(D)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 0 if lse is None else lse.data_ptr(),
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttentionFn.apply(q, k, v, causal, window)
    return _launch(*(_as_aligned(t) for t in (q, k, v)), causal, window)


# Kernel launches since the count was last set to 0 (CPU calls and empty
# inputs launch nothing and do not count).
flash_attention.launches = 0  # type: ignore[attr-defined]


class _FlashAttentionFn(torch.autograd.Function):
    """The kernel's forward with the row log-sum-exp kept, and the
    backward kernel for its gradient (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = (_as_aligned(t.detach()) for t in (q, k, v))
        B, S, H, _ = q.shape
        _check_head_dim(q.shape[3])
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        out = _launch(q, k, v, causal, window, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------------------
# The gradient
# ---------------------------------------------------------------------------

def _allowed(S: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """(S, S) bool: query i may attend key j."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= j > i - window
    return ok


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 scaled scores (B, H, S, S), query head h against KV head h // G."""
    G = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(q.shape[3])


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """The row log-sum-exp of the scaled scores in range, fp32 ``(B, H,
    S)``, as the forward kernel stores it (natural log)."""
    s = _scores(q, k).masked_fill(~_allowed(q.shape[1], causal, window, q.device), -math.inf)
    return torch.logsumexp(s, dim=-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                              causal: bool = True, window: Optional[int] = None):
    """The plain PyTorch version of the backward kernel: the gradient of
    attention in closed form, in fp32 from the given inputs, returned in
    q's dtype.  P = exp(S - lse) from the forward's log-sum-exp, Delta =
    rowsum(dO * o), dS = P * (dP - Delta); dK and dV sum over the G query
    heads of each KV head."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    ok = _allowed(S, causal, window, q.device)
    p = torch.where(ok, torch.exp(_scores(q, k) - lse.float()[..., None]), 0.0)
    dof = dout.float()
    vf = v.float().repeat_interleave(G, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)            # (B, H, S)
    ds = p * (dp - delta[..., None])
    kf = k.float().repeat_interleave(G, dim=2)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = (torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale).reshape(B, S, KV, G, D).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(B, S, KV, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_kernel_fn():
    """The backward's C entry point, its argument types declared."""
    from . import _build

    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 15
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None):
    """(dq, dk, dv) of attention, given the forward's inputs, output ``o``,
    row log-sum-exp ``lse`` (fp32 ``(B, H, S)``) and the output's gradient
    ``dout``; each in its input's dtype and shape.  A CUDA call launches
    the backward kernel (three kernels in order on the current stream, one
    launch counted); a CPU call computes :func:`flash_attention_bwd_plain`."""
    _check(q, k, v, causal, window)
    if o.shape != q.shape or dout.shape != q.shape or lse.shape != (q.shape[0], q.shape[2],
                                                                      q.shape[1]):
        raise ValueError(f"o {tuple(o.shape)}, dout {tuple(dout.shape)} and lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, dout, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not {q.device}")
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    _check_head_dim(D)
    q, k, v = (_as_aligned(t) for t in (q, k, v))
    o, dout = (_as_aligned(t.to(q.dtype)) for t in (o, dout))
    lse = lse.float().contiguous()
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, KV, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, KV, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = _bwd_kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, S, H, KV, D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                 *dout.stride()[:3],
                 int(causal), 0 if window is None else int(window),
                 1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


# Backward launches since the count was last set to 0 (one a call, for its
# three kernels; CPU calls launch nothing and do not count).
flash_attention_bwd.launches = 0  # type: ignore[attr-defined]
