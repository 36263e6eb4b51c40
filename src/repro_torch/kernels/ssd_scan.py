"""Mamba-2's SSD (state-space duality) chunked scan.

Every Mamba layer of the zoo's prefill (``ModelFamily.prefill`` for the
``ssm`` family) calls it once.  The sequence is cut into chunks of Q
positions; the intra-chunk part (a masked, decayed, attention-like
contraction, O(Q^2) a chunk) carries the arithmetic, and the inter-chunk
state recurrence is a short loop over chunks.

On a CUDA tensor :func:`ssd_chunk_scan` launches the hand-written Hopper
kernel in ``csrc/ssd_scan.cu`` for the intra-chunk part (it replaces the
Pallas TPU kernel ``repro/kernels/ssd_scan.py::_ssd_kernel``; the source
says how it is built) and then runs the inter-chunk recurrence and the
carried-state term as torch ops, as the reference runs them as XLA ops
outside its kernel.  On a CPU tensor it computes the same function with
:func:`ssd_chunk_scan_plain`, the port's ``models.mamba2.ssd_chunked``,
and only there: a CUDA tensor gets the kernel or an error, never the
plain version.

The contract is the reference's ``ssd_chunk_scan``: x ``(B, L, H, P)``,
dt ``(B, L, H)`` fp32 (after the softplus), A ``(H,)`` fp32 (negative),
B and C ``(B, L, N)``, ``L % chunk == 0``; it returns y ``(B, L, H, P)``
in x's dtype and the final state ``(B, H, P, N)`` in fp32, continuing
from ``initial_state`` when one is given.  The kernel takes x, B and C in
fp32 or bf16, P <= 64 and N <= 128 (every SSM config of the repo).

No backward exists, in the reference or here: a CUDA input that needs a
gradient while grad mode is on raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_P, MAX_N = 64, 128  # the kernel's register tiles


def ssd_chunk_scan_plain(x, dt, A, B_mat, C_mat, chunk: int,
                         initial_state: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the port's ``ssd_chunked`` (the
    reference oracle ``ssd_scan_ref``)."""
    from ..models.mamba2 import ssd_chunked

    return ssd_chunked(x, dt, A, B_mat, C_mat, chunk, initial_state)


def ssd_intra_chunk_plain(x, dt, A, B_mat, C_mat, chunk: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel alone (the Pallas kernel's
    arithmetic): y_diag ``(B, C, H, Q, P)``, chunk states ``(B, C, H, P,
    N)`` and a_cs ``(B, C, H, Q)``, all fp32."""
    Bsz, L, H, P = x.shape
    N = B_mat.shape[-1]
    n = L // chunk
    xc = x.float().reshape(Bsz, n, chunk, H, P).permute(0, 1, 3, 2, 4)    # (B, C, H, Q, P)
    dtc = dt.float().reshape(Bsz, n, chunk, H).permute(0, 1, 3, 2)        # (B, C, H, Q)
    Bc = B_mat.float().reshape(Bsz, n, chunk, N)
    Cc = C_mat.float().reshape(Bsz, n, chunk, N)
    a_cs = torch.cumsum(dtc * A.float()[:, None], dim=-1)                 # (B, C, H, Q)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    diff = (a_cs[..., :, None] - a_cs[..., None, :]).masked_fill(~tril, 0.0)
    decay = torch.exp(diff).masked_fill(~tril, 0.0)                       # (B, C, H, Q, Q)
    scores = Cc @ Bc.transpose(-1, -2)                                    # (B, C, Q, Q)
    xdt = xc * dtc[..., None]
    y = (decay * scores[:, :, None]) @ xdt                                # (B, C, H, Q, P)
    w = xdt * torch.exp(a_cs[..., -1:] - a_cs)[..., None]                 # (B, C, H, Q, P)
    states = w.transpose(-1, -2) @ Bc[:, :, None]                         # (B, C, H, P, N)
    return y, states, a_cs


def inter_chunk(y_diag: torch.Tensor, states: torch.Tensor, a_cs: torch.Tensor,
                C_mat: torch.Tensor, initial_state: Optional[torch.Tensor],
                out_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference wrapper's torch-side part (``ssd_scan.py:118-141``):
    from the kernel's y_diag ``(B, C, H, Q, P)``, chunk states ``(B, C, H,
    P, N)`` and a_cs ``(B, C, H, Q)``, run the state recurrence over the
    chunks and add each chunk's carried-state term ``C h_prev exp(a_cs)``.
    Returns y ``(B, L, H, P)`` in ``out_dtype`` and the final state."""
    Bsz, n_chunks, H, Q, P = y_diag.shape
    N = states.shape[-1]
    chunk_decay = torch.exp(a_cs[:, :, :, -1])                     # (B, C, H)
    h = (initial_state.float() if initial_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=y_diag.device))
    h_prevs = []
    for c in range(n_chunks):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                           # (B, C, H, P, N)
    Cc = C_mat.float().reshape(Bsz, n_chunks, Q, N)
    y_off = torch.einsum("bcln,bchpn,bchl->bchlp", Cc, h_prev, torch.exp(a_cs))
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(Bsz, n_chunks * Q, H, P)
    return y.to(out_dtype), h


def _check(x, dt, A, B_mat, C_mat, chunk: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, L, H, P), got {tuple(x.shape)}")
    Bsz, L, H, P = x.shape
    if tuple(dt.shape) != (Bsz, L, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if B_mat.shape != C_mat.shape or B_mat.dim() != 3 or tuple(B_mat.shape[:2]) != (Bsz, L):
        raise ValueError(f"B {tuple(B_mat.shape)} and C {tuple(C_mat.shape)} must be "
                         f"(B, L, N) for x {tuple(x.shape)}")
    if chunk <= 0 or L % chunk:
        raise ValueError(f"seq {L} not divisible by chunk {chunk}")
    devices = {t.device for t in (x, dt, A, B_mat, C_mat)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")


def _kernel_fn():
    """The C entry point, its argument types declared (64-bit pointers,
    strides and stream)."""
    from . import _build

    fn = _build.load("ssd_scan").ssd_scan_launch
    if not fn.argtypes:
        fn.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 10
            + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _rows_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_mat: torch.Tensor,
                    C_mat: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel alone, on CUDA tensors: y_diag ``(B, C, H, Q, P)``,
    chunk states ``(B, C, H, P, N)`` and a_cs ``(B, C, H, Q)``, all fp32,
    the Pallas kernel's three outputs."""
    Bsz, L, H, P = x.shape
    N = B_mat.shape[-1]
    if x.dtype not in _DTYPE_CODES or B_mat.dtype != x.dtype or C_mat.dtype != x.dtype:
        raise TypeError(f"ssd_chunk_scan takes x, B, C of one dtype, float32 or bfloat16; "
                        f"got {x.dtype}, {B_mat.dtype}, {C_mat.dtype}")
    if P > MAX_P or P % 4 or N > MAX_N or N % 4 or chunk % 2:
        raise ValueError(f"the ssd_chunk_scan kernel takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"multiples of 4, and an even chunk; got P={P} N={N} chunk={chunk}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B_mat, C_mat)):
        raise RuntimeError(
            "ssd_chunk_scan has no backward (neither has the reference's Pallas kernel); "
            "training through it comes with ROADMAP.md queue 1, item 17 (training the zoo)")
    x, B_mat, C_mat = (_rows_contiguous(t) for t in (x, B_mat, C_mat))
    dt = dt.float()
    A = A.float().contiguous()
    n_chunks = L // chunk
    dev = x.device
    y = torch.empty((Bsz, n_chunks, H, chunk, P), dtype=torch.float32, device=dev)
    states = torch.empty((Bsz, n_chunks, H, P, N), dtype=torch.float32, device=dev)
    a_cs = torch.empty((Bsz, n_chunks, H, chunk), dtype=torch.float32, device=dev)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
                 y.data_ptr(), states.data_ptr(), a_cs.data_ptr(),
                 Bsz, L, H, P, N, chunk,
                 x.stride(0), x.stride(1), x.stride(2),
                 dt.stride(0), dt.stride(1), dt.stride(2),
                 B_mat.stride(0), B_mat.stride(1), C_mat.stride(0), C_mat.stride(1),
                 _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_scan kernel launch failed: CUDA error {err}")
    ssd_chunk_scan.launches += 1
    return y, states, a_cs


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_mat: torch.Tensor,
                   C_mat: torch.Tensor, chunk: int = 256,
                   initial_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full SSD: ``(y (B, L, H, P) in x's dtype, final_state (B, H, P,
    N) fp32)``.  CUDA inputs go through the intra-chunk kernel, launched
    on the current stream without a synchronize, then :func:`inter_chunk`;
    CPU inputs through :func:`ssd_chunk_scan_plain`."""
    _check(x, dt, A, B_mat, C_mat, chunk)
    if x.device.type == "cpu":
        return ssd_chunk_scan_plain(x, dt, A, B_mat, C_mat, chunk, initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan runs on cuda or cpu, not {x.device}")
    y_diag, states, a_cs = ssd_intra_chunk(x, dt, A, B_mat, C_mat, chunk)
    return inter_chunk(y_diag, states, a_cs, C_mat, initial_state, x.dtype)


# Kernel launches since the count was last set to 0 (CPU calls launch
# nothing and do not count).
ssd_chunk_scan.launches = 0  # type: ignore[attr-defined]
