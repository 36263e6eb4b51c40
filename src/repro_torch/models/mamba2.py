"""Mamba-2 (SSD — state-space duality) block, the port of
``repro/models/mamba2.py``.

The chunked SSD algorithm of arXiv:2405.21060 for prefill (a loop over
chunks for the inter-chunk state recurrence) and the O(1)-per-token
recurrent step for decode.  :func:`mamba_forward` runs the scan through
:func:`repro_torch.kernels.ops.ssd_scan`: the hand-written kernel on a
CUDA tensor, :func:`ssd_chunked` (this module's plain version, the
kernel's oracle) on a CPU tensor.

Shapes: d_inner = expand * d_model, H = d_inner / head_dim SSD heads,
N = ssm_state, single B/C group (G=1).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import Params, _normal


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    d = cfg.d_model
    d_inner = cfg.d_inner
    N = cfg.ssm_state
    H = cfg.ssm_heads
    K = cfg.ssm_conv
    conv_dim = d_inner + 2 * N
    wdt = cfg.weight_dtype
    d_in_proj = 2 * d_inner + 2 * N + H  # z, xBC, dt
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _normal(gen, (d, d_in_proj), 1.0 / math.sqrt(d), wdt, device),
        "conv_w": _normal(gen, (K, conv_dim), 1.0 / math.sqrt(K), wdt, device),
        "conv_b": torch.zeros((conv_dim,), dtype=wdt, device=device),
        "dt_bias": torch.zeros((H,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "norm_scale": torch.ones((d_inner,), dtype=wdt, device=device),
        "out_proj": _normal(gen, (d_inner, d), 1.0 / math.sqrt(d_inner), wdt, device),
    }


# ---------------------------------------------------------------------------
# SSD chunked scan (prefill) — the plain version of the kernel
# ---------------------------------------------------------------------------

def _exp(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of fp32 decay exponents, evaluated in fp64 and rounded once
    to fp32.  torch's fp32 ``exp`` on the CPU was seen, on the first call
    in a process after other tests, to return one worker thread's share
    of an 8192-element tensor with up to 1.5e-4 relative error (its inputs
    bit-equal, a second call exact): 2e-3 in y, beyond the 2e-5 parity
    tolerance.  The fp64 path is another kernel, and any error it has is
    below fp32's rounding."""
    return torch.exp(x.double()).to(x.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) -> (..., Q, Q) with out[i, j] = sum_{k=j+1..i} a[k] for
    i >= j, -inf above the diagonal."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,      # (B, L, H, P)
    dt: torch.Tensor,     # (B, L, H) fp32 (post-softplus)
    A: torch.Tensor,      # (H,) fp32 negative
    B_mat: torch.Tensor,  # (B, L, N)
    C_mat: torch.Tensor,  # (B, L, N)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B, L, H, P), final_state: (B, H, P, N))."""
    Bsz, L, H, P = x.shape
    N = B_mat.shape[-1]
    if L % chunk:
        raise ValueError(f"seq {L} not divisible by chunk {chunk}")
    n_chunks = L // chunk

    xc = x.float().reshape(Bsz, n_chunks, chunk, H, P)
    dtc = dt.float().reshape(Bsz, n_chunks, chunk, H)
    Bc = B_mat.float().reshape(Bsz, n_chunks, chunk, N)
    Cc = C_mat.float().reshape(Bsz, n_chunks, chunk, N)

    a = dtc * A                                               # (B, C, Q, H)
    a_cumsum = torch.cumsum(a, dim=2)                         # (B, C, Q, H)
    xdt = xc * dtc[..., None]                                 # x * dt

    # Intra-chunk (diagonal) output.
    Lmat = _exp(_segsum(a.permute(0, 1, 3, 2)))               # (B, C, H, Q, Q)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)          # (B, C, Q, Q)
    y_diag = torch.einsum("bchls,bcls,bcshp->bclhp", Lmat, scores, xdt)

    # Chunk-final states.
    decay_states = _exp(a_cumsum[:, :, -1:, :] - a_cumsum)    # (B, C, Q, H)
    states = torch.einsum("bcsn,bcshp,bcsh->bchpn", Bc, xdt, decay_states)

    # Inter-chunk recurrence (a loop over chunks).
    chunk_decay = _exp(a_cumsum[:, :, -1, :])                 # (B, C, H)
    h = (initial_state.float() if initial_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device))
    h_prevs = []
    for c in range(n_chunks):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                      # (B, C, H, P, N)

    # Inter-chunk (off-diagonal) output: contribution of the carried state.
    state_decay = _exp(a_cumsum)                              # (B, C, Q, H)
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, h_prev, state_decay)

    y = (y_diag + y_off).reshape(Bsz, L, H, P)
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# Block forward (prefill)
# ---------------------------------------------------------------------------

def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: xBC (B, L, C), w (K, C).  The reference's sum
    of shifted products (``F.conv1d`` would go through cuDNN, in TF32 by
    default)."""
    K = w.shape[0]
    L = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:L, :] * w[0][None, None, :]
    for i in range(1, K):
        out = out + pad[:, i:i + L, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """Mamba-2's norm before out_proj: rmsnorm(y * silu(z)) * scale."""
    yf = (y * F.silu(z)).float()
    rms = torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
    return (yf * rms * scale.float()).to(dtype)


def mamba_forward(
    p: Params,
    u: torch.Tensor,          # (B, L, d_model)
    cfg: ModelConfig,
    initial_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    d_inner, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = u @ p["in_proj"]
    z, xBC, dt_raw = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)
    xBC = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
    x, B_mat, C_mat = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    Bsz, L, _ = u.shape
    xh = x.reshape(Bsz, L, H, P)
    y, h_final = ops.ssd_scan(xh, dt, A, B_mat, C_mat, cfg.ssm_chunk, initial_state)
    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = _gated_rmsnorm(y.reshape(Bsz, L, d_inner), z, p["norm_scale"], u.dtype)
    out = y @ p["out_proj"]
    if return_state:
        return out, h_final
    return out


# ---------------------------------------------------------------------------
# Decode (single-token recurrent step)
# ---------------------------------------------------------------------------

def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device="cuda") -> Dict[str, torch.Tensor]:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def mamba_decode_step(
    p: Params,
    u: torch.Tensor,          # (B, 1, d_model)
    cache: Dict[str, torch.Tensor],
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    d_inner, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Bsz = u.shape[0]
    zxbcdt = u[:, 0, :] @ p["in_proj"]                        # (B, ...)
    z, xBC, dt_raw = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)

    # Rolling conv buffer.
    conv_in = torch.cat([cache["conv"], xBC[:, None, :]], dim=1)  # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", conv_in, p["conv_w"]) + p["conv_b"]
    xBC = F.silu(conv_out)
    new_conv = conv_in[:, 1:, :]

    x, B_mat, C_mat = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])            # (B, H)
    A = -torch.exp(p["A_log"])                                # (H,)

    xh = x.reshape(Bsz, H, P).float()
    decay = torch.exp(dt * A)                                 # (B, H)
    h = cache["ssm"] * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, B_mat.float())
    y = torch.einsum("bhpn,bn->bhp", h, C_mat.float())
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(Bsz, d_inner).to(u.dtype)

    y = _gated_rmsnorm(y, z, p["norm_scale"], u.dtype)
    out = (y @ p["out_proj"])[:, None, :]                     # (B, 1, d_model)
    return out, {"conv": new_conv, "ssm": h}


def ssd_reference(x, dt, A, B_mat, C_mat, initial_state=None):
    """O(L) sequential reference for tests: exact recurrent semantics."""
    Bsz, L, H, P = x.shape
    N = B_mat.shape[-1]
    h = (initial_state.float() if initial_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device))
    xf, Bf, Cf = x.float(), B_mat.float(), C_mat.float()
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t] * A)                       # (B, H)
        h = h * decay[:, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h
