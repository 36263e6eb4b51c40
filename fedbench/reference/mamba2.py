"""Mamba-2 (Dao & Gu, "Transformers are SSMs", arXiv:2405.21060) in plain
PyTorch: the LM the ``mamba2`` configurations name, float32 throughout.

Per layer, residual: RMSNorm, then the Mamba-2 mixer: ``in_proj`` to
(z, xBC, dt); a depthwise causal convolution of width ``d_conv`` over
xBC, written as shifted products, plus its bias; SiLU; xBC split into
x (``expand * d_model``, as H heads of ``headdim``), B and C (``d_state``
each, one group); dt = softplus(dt + dt_bias), A = -exp(A_log); the SSD
y = SSM(A, B, C)(x) (below) plus D x; the gated RMSNorm
rmsnorm(y * silu(z)) * scale; ``out_proj``.  A final RMSNorm, logits
through the tied embedding (its rows padded as the configuration pads
them), mean cross-entropy over every position.

The SSD is the paper's chunked form (its Listing 1), worked out from the
recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t:
within each chunk of ``chunk_size`` positions the quadratic form
y = (L o C B^T)(x dt) with the Q x Q decay mask L[l, s] = exp(sum of
dt A over s < k <= l) for s <= l and 0 above it, each segment sum taken
as a cumulative sum of masked terms (no difference of cumulative sums);
the chunk-final states, sum_s exp(sum over s < k < Q) B_s (x dt)_s; a
recurrence over the chunks carrying the state with each chunk's whole
decay; and each position's share of the state carried in,
exp(sum over k <= l) C_l h_in.

Departures from the published model: the norms' epsilon is the
configuration's ``norm_eps`` (1e-6 as run; Mamba-2 uses 1e-5), the
weights are random from the seed, and every step is float32 (the
published model keeps its residual stream in float32 too,
``residual_in_fp32``, and its other activations in its compute dtype).
Each layer is recomputed in the backward (activation checkpointing) so
that the float32 round trains in one card's memory; that changes no
value.

Weights come in the system's stacked layout: ``embed/embedding`` (V, D),
``layers/norm/scale`` (L, D), ``layers/mamba/{in_proj (L, D, 2E+2N+H),
conv_w (L, K, E+2N), conv_b (L, E+2N), dt_bias, A_log, D (L, H),
norm_scale (L, E), out_proj (L, E, D)}``, ``final_norm/scale`` (D,).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Precision


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B, S, C), w (K, C): out[t] = b + sum_j w[K-1-j] * x[t-j], x before
    the first position zero."""
    K, S = w.shape[0], x.shape[1]
    out = b + w[K - 1] * x
    for j in range(1, K):
        delayed = torch.cat([x.new_zeros(x.shape[0], j, x.shape[2]), x[:, :S - j]], dim=1)
        out = out + w[K - 1 - j] * delayed
    return out


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) -> (..., Q, Q): out[l, s] = sum of a[k] over s < k <= l for
    s <= l (0 on the diagonal), -inf above it."""
    Q = a.shape[-1]
    rep = a[..., :, None].expand(*a.shape, Q)                   # rep[k, s] = a[k]
    below = torch.ones(Q, Q, dtype=torch.bool, device=a.device).tril(-1)
    out = rep.masked_fill(~below, 0.0).cumsum(dim=-2)
    return out.masked_fill(~torch.ones_like(below).tril(), float("-inf"))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
        chunk: int, prec: Precision) -> torch.Tensor:
    """x (B, S, H, P), dt (B, S, H), A (H,), B and C (B, S, N), a zero
    initial state: y (B, S, H, P)."""
    Bsz, S, H, P = x.shape
    N, Q = Bm.shape[-1], chunk
    n = S // Q
    xc = x.reshape(Bsz, n, Q, H, P).permute(0, 1, 3, 2, 4)       # (B, n, H, Q, P)
    a = (dt * A).reshape(Bsz, n, Q, H).permute(0, 1, 3, 2)       # (B, n, H, Q)
    xdt = xc * dt.reshape(Bsz, n, Q, H).permute(0, 1, 3, 2)[..., None]
    Bc, Cc = Bm.reshape(Bsz, n, Q, N), Cm.reshape(Bsz, n, Q, N)
    seg = segsum(a)                                              # (B, n, H, Q, Q)
    # Within the chunk: (L o C B^T) (x dt).
    scores = prec.mm(Cc, Bc.transpose(-1, -2))                   # (B, n, Q, Q)
    y = prec.mm(torch.exp(seg) * scores[:, :, None], xdt)        # (B, n, H, Q, P)
    # Each chunk's final state: its positions decayed to the chunk's end.
    to_end = torch.exp(seg[..., -1, :])                          # (B, n, H, Q)
    states = prec.mm((xdt * to_end[..., None]).transpose(-1, -2), Bc[:, :, None])  # (B, n, H, P, N)
    # Between chunks: the state carried into each chunk.
    whole = torch.exp(a.sum(-1))                                 # (B, n, H)
    h = x.new_zeros(Bsz, H, P, N)
    carried: List[torch.Tensor] = []
    for c in range(n):
        carried.append(h)
        h = h * whole[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(carried, dim=1)                           # (B, n, H, P, N)
    from_start = torch.exp(a.cumsum(-1))                         # (B, n, H, Q)
    y = y + prec.mm(Cc[:, :, None], h_in.transpose(-1, -2)) * from_start[..., None]
    return y.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P)


def _mixer(u: torch.Tensor, w: Dict[str, torch.Tensor], cfg: Dict[str, Any],
           prec: Precision) -> torch.Tensor:
    Bsz, S, _ = u.shape
    E = cfg["expand"] * cfg["d_model"]
    P, N = cfg["headdim"], cfg["d_state"]
    H = E // P
    z, xBC, dt = prec.mm(u, w["in_proj"]).split([E, E + 2 * N, H], dim=-1)
    xBC = F.silu(_causal_conv(xBC, w["conv_w"], w["conv_b"]))
    x, Bm, Cm = xBC.split([E, N, N], dim=-1)
    dt = F.softplus(dt + w["dt_bias"])
    xh = x.reshape(Bsz, S, H, P)
    y = ssd(xh, dt, -torch.exp(w["A_log"]), Bm, Cm, cfg["chunk_size"], prec)
    y = (y + xh * w["D"][:, None]).reshape(Bsz, S, E)
    return prec.mm(_rms_norm(y * F.silu(z), w["norm_scale"], cfg["norm_eps"]), w["out_proj"])


def loss(params: Dict[str, Any], batch, cfg: Dict[str, Any], prec: Precision,
         lora: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of a (tokens, labels) batch, both
    (B, S); every leaf of ``params`` float32."""
    tokens, labels = batch
    B, S = tokens.shape
    eps = cfg["norm_eps"]
    emb = params["embed"]["embedding"]
    x = F.embedding(tokens, emb)
    # One unbind a stacked leaf: indexing each layer would give every
    # layer's gradient the whole stack's size.
    mixer = {k: t.unbind(0) for k, t in params["layers"]["mamba"].items()}
    norm = params["layers"]["norm"]["scale"].unbind(0)

    def layer(x: torch.Tensor, i: int) -> torch.Tensor:
        w = {k: t[i] for k, t in mixer.items()}
        return x + _mixer(_rms_norm(x, norm[i], eps), w, cfg, prec)

    for i in range(cfg["n_layer"]):
        x = checkpoint(layer, x, i, use_reentrant=False) if x.requires_grad else layer(x, i)
    logits = prec.mm(_rms_norm(x, params["final_norm"]["scale"], eps), emb.t())
    return F.cross_entropy(logits.reshape(B * S, -1), labels.reshape(-1).long())
