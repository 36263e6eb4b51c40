"""Mamba-2's SSD (state-space duality) chunked scan.

Every Mamba layer of the zoo's prefill (``ModelFamily.prefill`` for the
``ssm`` family) calls it once.  The sequence is cut into chunks of Q
positions; the intra-chunk part (a masked, decayed, attention-like
contraction, O(Q^2) a chunk) carries the arithmetic, and the inter-chunk
state recurrence is a short loop over chunks.

On a CUDA tensor :func:`ssd_chunk_scan` launches the hand-written Hopper
kernel in ``csrc/ssd_scan.cu`` for the intra-chunk part (it replaces the
Pallas TPU kernel ``repro/kernels/ssd_scan.py::_ssd_kernel``).  Its y
blocks form each score tile C·Bᵀ once for a group of 4 heads (on the
tensor cores, ``mma.sync``, when B and C are bf16) and multiply it into
the 4 heads' outputs; its state blocks fold x·dt·decay into the chunk
states of 2 heads.  y and the states are fp32 products on the CUDA
cores, which is what holds it back now; the source says more.  It then
runs the inter-chunk recurrence and the
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
fp32 or bf16, P <= 64 and N <= 128 (every SSM config of the repo), and
reads them 4 elements at a time: the wrapper copies one whose base or
strides do not allow that.

The reference has no backward kernel: JAX differentiates ``ssd_chunked``.
Here a CUDA input that needs a gradient goes through
:class:`_SSDIntraChunkFn`, whose backward is the hand-written kernel in
``csrc/ssd_scan_bwd.cu`` (:func:`ssd_intra_chunk_bwd`: its products on the
tensor cores in 3xTF32, the heads' partial sums added across a thread-block
cluster, dA summed on the card); ``inter_chunk``
keeps torch autograd, as the reference keeps it in XLA.  Its plain
version, :func:`ssd_intra_chunk_bwd_plain`, writes the gradient out in
torch ops; the CPU path and the tests use it.  With the program's spans on
(:mod:`repro_torch.utils.spans`) the backward is the span ``ssm.scan.bwd``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils import spans

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
    # One unbind, not an index a chunk: the backward of ``states[:, c]`` is
    # a zero tensor of all the states with one chunk filled, so C chunks
    # would add C states-sized gradients; unbind's backward stacks them once.
    for st, dec in zip(states.unbind(1), chunk_decay.unbind(1)):
        h_prevs.append(h)
        h = h * dec[:, :, None, None] + st
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


def _rows_vectorized(t: torch.Tensor) -> bool:
    """The last axis contiguous, the other strides multiples of 4 elements
    and the base on 4 elements: the kernel reads x, B and C 4 elements at a
    time (its launcher refuses anything else)."""
    return (t.stride(-1) == 1 and all(st % 4 == 0 for st in t.stride()[:-1])
            and t.data_ptr() % (4 * t.element_size()) == 0)


def _as_vectorized(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel can read it, else a fresh contiguous
    copy (``contiguous()`` would hand back a misaligned contiguous tensor as
    it is)."""
    return t if _rows_vectorized(t) else t.clone(memory_format=torch.contiguous_format)


def _check_kernel_inputs(x: torch.Tensor, B_mat: torch.Tensor, C_mat: torch.Tensor,
                        chunk: int, what: str) -> None:
    """What both kernels take: x, B, C of one dtype, float32 or bfloat16;
    P <= MAX_P and N <= MAX_N, multiples of 4; an even chunk."""
    P, N = x.shape[-1], B_mat.shape[-1]
    if x.dtype not in _DTYPE_CODES or B_mat.dtype != x.dtype or C_mat.dtype != x.dtype:
        raise TypeError(f"{what} takes x, B, C of one dtype, float32 or bfloat16; "
                        f"got {x.dtype}, {B_mat.dtype}, {C_mat.dtype}")
    if P > MAX_P or P % 4 or N > MAX_N or N % 4 or chunk % 2:
        raise ValueError(f"the {what} kernel takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"multiples of 4, and an even chunk; got P={P} N={N} chunk={chunk}")


def _launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_mat: torch.Tensor,
            C_mat: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors, no autograd."""
    Bsz, L, H, P = x.shape
    N = B_mat.shape[-1]
    _check_kernel_inputs(x, B_mat, C_mat, chunk, "ssd_chunk_scan")
    x, B_mat, C_mat = (_as_vectorized(t) for t in (x, B_mat, C_mat))
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


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_mat: torch.Tensor,
                    C_mat: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel alone, on CUDA tensors: y_diag ``(B, C, H, Q, P)``,
    chunk states ``(B, C, H, P, N)`` and a_cs ``(B, C, H, Q)``, all fp32,
    the Pallas kernel's three outputs.  Where an input needs a gradient it
    goes through :class:`_SSDIntraChunkFn`, whose backward is the backward
    kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B_mat, C_mat)):
        return _SSDIntraChunkFn.apply(x, dt, A, B_mat, C_mat, chunk)
    return _launch(x, dt, A, B_mat, C_mat, chunk)


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_mat: torch.Tensor,
                   C_mat: torch.Tensor, chunk: int = 256,
                   initial_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full SSD: ``(y (B, L, H, P) in x's dtype, final_state (B, H, P,
    N) fp32)``.  CUDA inputs go through the intra-chunk kernel, launched
    on the current stream without a synchronize (its backward kernel where
    an input needs a gradient), then :func:`inter_chunk`; CPU inputs
    through :func:`ssd_chunk_scan_plain`, and so do ``meta`` inputs, for
    which it computes only shapes (the dry-run's)."""
    _check(x, dt, A, B_mat, C_mat, chunk)
    if x.device.type in ("cpu", "meta"):
        return ssd_chunk_scan_plain(x, dt, A, B_mat, C_mat, chunk, initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan runs on cuda, cpu or meta, not {x.device}")
    y_diag, states, a_cs = ssd_intra_chunk(x, dt, A, B_mat, C_mat, chunk)
    return inter_chunk(y_diag, states, a_cs, C_mat, initial_state, x.dtype)


# Kernel launches since the count was last set to 0 (CPU and meta calls
# launch nothing and do not count).
ssd_chunk_scan.launches = 0  # type: ignore[attr-defined]


class _SSDIntraChunkFn(torch.autograd.Function):
    """The intra-chunk part with its gradient: the forward kernel and the
    backward kernel on CUDA tensors, the plain versions of both on CPU
    tensors (the tests')."""

    @staticmethod
    def forward(ctx, x, dt, A, B_mat, C_mat, chunk):
        x, dt, A, B_mat, C_mat = (t.detach() for t in (x, dt, A, B_mat, C_mat))
        if x.device.type == "cuda":
            y, states, a_cs = _launch(x, dt, A, B_mat, C_mat, chunk)
        else:
            y, states, a_cs = ssd_intra_chunk_plain(x, dt, A, B_mat, C_mat, chunk)
        ctx.save_for_backward(x, dt, A, B_mat, C_mat, a_cs)
        return y, states, a_cs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dstates, da_cs):
        # An output the caller did not use arrives as zeros (autograd
        # materializes them by default).
        x, dt, A, B_mat, C_mat, a_cs = ctx.saved_tensors
        # Autograd runs this on its own thread: the span has no parent there.
        with spans.span("ssm.scan.bwd"):
            dx, ddt, dA, dB, dC = ssd_intra_chunk_bwd(x, dt, A, B_mat, C_mat, a_cs, dy,
                                                      dstates, da_cs)
        return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC, None


# ---------------------------------------------------------------------------
# The gradient
# ---------------------------------------------------------------------------

def ssd_intra_chunk_bwd_plain(x, dt, A, B_mat, C_mat, a_cs, dy, dstates, da_cs):
    """The plain PyTorch version of the backward kernel, in fp32 torch ops.

    From the forward's inputs, its a_cs ``(B, C, H, Q)`` and the gradients
    of its three outputs (dy ``(B, C, H, Q, P)``, dstates ``(B, C, H, P,
    N)``, da_cs ``(B, C, H, Q)``), the gradients of x, dt, A, B and C, each
    in its input's dtype.  Per (b, chunk, head), with xdt = x·dt, G = C Bᵀ
    (shared by the heads), Lm[l, s] = exp(a_cs[l] − a_cs[s]) for s <= l
    and 0 above the diagonal, M = Lm ∘ G, decay = exp(a_cs[Q−1] − a_cs),
    w = xdt ∘ decay and R = B dstatesᵀ:

        dM   = dy xdtᵀ (masked)        dxdt = Mᵀ dy + decay ∘ R
        dG   = Σ_h dM ∘ Lm             dC   = dG B
        dB   = dGᵀ C + Σ_h w dstates   dT   = dM ∘ M
        d a_cs = da_cs + rowsum(dT) − colsum(dT) − u, and + Σ u at Q−1,
                 with u = rowsum(w ∘ R);
        da   = the reverse cumulative sum of d a_cs;
        ddt  = da·A + rowsum(dxdt ∘ x),  dA = Σ da·dt,  dx = dxdt·dt.

    The decays are evaluated in fp64 and rounded once, as the port's
    ``ssd_chunked`` evaluates them."""
    from ..models.mamba2 import _exp

    Bsz, L, H, P = x.shape
    N = B_mat.shape[-1]
    Q = a_cs.shape[-1]
    n = L // Q
    xc = x.float().reshape(Bsz, n, Q, H, P).permute(0, 1, 3, 2, 4)      # (B, C, H, Q, P)
    dtc = dt.float().reshape(Bsz, n, Q, H).permute(0, 1, 3, 2)          # (B, C, H, Q)
    Bc = B_mat.float().reshape(Bsz, n, Q, N)
    Cc = C_mat.float().reshape(Bsz, n, Q, N)
    a = a_cs.float()
    dy, dst = dy.float(), dstates.float()
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    Lm = _exp((a[..., :, None] - a[..., None, :]).masked_fill(~tril, 0.0)).masked_fill(~tril, 0.0)
    M = Lm * (Cc @ Bc.transpose(-1, -2))[:, :, None]                    # (B, C, H, Q, Q)
    xdt = xc * dtc[..., None]
    decay = _exp(a[..., -1:] - a)                                       # (B, C, H, Q)
    w = xdt * decay[..., None]
    dM = (dy @ xdt.transpose(-1, -2)).masked_fill(~tril, 0.0)
    R = Bc[:, :, None] @ dst.transpose(-1, -2)                          # (B, C, H, Q, P)
    dxdt = M.transpose(-1, -2) @ dy + decay[..., None] * R
    dG = (dM * Lm).sum(2)                                               # (B, C, Q, Q)
    dC = dG @ Bc
    dB = dG.transpose(-1, -2) @ Cc + (w.transpose(-1, -2).reshape(Bsz, n, H * P, Q)
                                      .transpose(-1, -2) @ dst.reshape(Bsz, n, H * P, N))
    dT = dM * M
    u = (w * R).sum(-1)
    d_acs = da_cs.float() + dT.sum(-1) - dT.sum(-2) - u
    d_acs[..., -1] += u.sum(-1)
    da = d_acs.flip(-1).cumsum(-1).flip(-1)
    ddt = da * A.float()[:, None] + (dxdt * xc).sum(-1)
    dA = (da * dtc).sum((0, 1, 3))
    dx = dxdt * dtc[..., None]
    return (dx.permute(0, 1, 3, 2, 4).reshape(Bsz, L, H, P).to(x.dtype),
            ddt.permute(0, 1, 3, 2).reshape(Bsz, L, H).to(dt.dtype),
            dA.to(A.dtype),
            dB.reshape(Bsz, L, N).to(B_mat.dtype),
            dC.reshape(Bsz, L, N).to(C_mat.dtype))


def _bwd_kernel_fn():
    """The backward's C entry point and its scratch size, argument types
    declared (64-bit pointers, strides and stream)."""
    from . import _build

    lib = _build.load("ssd_scan_bwd")
    fn = lib.ssd_scan_bwd_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 14
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        size = lib.ssd_scan_bwd_scratch_floats
        size.argtypes = [ctypes.c_int] * 7
        size.restype = ctypes.c_int64
    return fn, lib.ssd_scan_bwd_scratch_floats


def ssd_intra_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B_mat: torch.Tensor, C_mat: torch.Tensor, a_cs: torch.Tensor,
                        dy: torch.Tensor, dstates: torch.Tensor, da_cs: torch.Tensor):
    """(dx, ddt, dA, dB, dC) of the intra-chunk part, each in its input's
    dtype and shape, given the forward's inputs, its a_cs and the three
    outputs' gradients.  A CUDA call launches the backward kernel (its three
    kernels in order on the current stream, one launch counted, nothing
    after it: dA too is summed on the card); a CPU call computes
    :func:`ssd_intra_chunk_bwd_plain`."""
    if a_cs.dim() != 4 or x.dim() != 4 or x.shape[1] % a_cs.shape[-1]:
        raise ValueError(f"a_cs {tuple(a_cs.shape)} must be (B, C, H, Q) with Q dividing the "
                         f"sequence of x {tuple(x.shape)}")
    _check(x, dt, A, B_mat, C_mat, a_cs.shape[-1])
    Bsz, L, H, P = x.shape
    N, Q = B_mat.shape[-1], a_cs.shape[-1]
    n = L // Q
    want = {"a_cs": (a_cs, (Bsz, n, H, Q)), "dy": (dy, (Bsz, n, H, Q, P)),
            "dstates": (dstates, (Bsz, n, H, P, N)), "da_cs": (da_cs, (Bsz, n, H, Q))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does not match x "
                             f"{tuple(x.shape)} on {x.device} with chunk {Q}: want {shape}")
    if x.device.type == "cpu":
        return ssd_intra_chunk_bwd_plain(x, dt, A, B_mat, C_mat, a_cs, dy, dstates, da_cs)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk_bwd runs on cuda or cpu, not {x.device}")
    _check_kernel_inputs(x, B_mat, C_mat, Q, "ssd_intra_chunk_bwd")
    x, B_mat, C_mat = (_as_vectorized(t) for t in (x, B_mat, C_mat))
    dt = dt.float()
    A, a_cs, dstates, da_cs = (t.float().contiguous() for t in (A, a_cs, dstates, da_cs))
    dy = _as_vectorized(dy.float())
    dev = x.device
    dx = torch.empty((Bsz, L, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bsz, L, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dB = torch.empty((Bsz, L, N), dtype=B_mat.dtype, device=dev)
    dC = torch.empty((Bsz, L, N), dtype=C_mat.dtype, device=dev)
    fn, scratch_floats = _bwd_kernel_fn()
    code = _DTYPE_CODES[x.dtype]
    scratch = torch.empty(max(1, scratch_floats(Bsz, L, H, P, N, Q, code)), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
                 a_cs.data_ptr(), dy.data_ptr(), dstates.data_ptr(), da_cs.data_ptr(),
                 dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                 scratch.data_ptr(),
                 Bsz, L, H, P, N, Q,
                 x.stride(0), x.stride(1), x.stride(2),
                 dt.stride(0), dt.stride(1), dt.stride(2),
                 B_mat.stride(0), B_mat.stride(1), C_mat.stride(0), C_mat.stride(1),
                 *dy.stride()[:4],
                 code, stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk_bwd kernel launch failed: CUDA error {err}")
    ssd_intra_chunk_bwd.launches += 1
    return dx, ddt, dA, dB, dC


# Backward launches since the count was last set to 0 (one a call, for all
# its kernels; CPU calls launch nothing and do not count).
ssd_intra_chunk_bwd.launches = 0  # type: ignore[attr-defined]
