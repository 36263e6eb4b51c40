"""OLMo (arXiv:2402.00838) in plain PyTorch: the decoder the ``olmo``
configurations name, float32 throughout.

Per layer: non-parametric LayerNorm (no scale, no bias), multi-head
attention with rotary embeddings on the two halves of each head
(theta 10,000), causal softmax attention, then non-parametric LayerNorm
and a SwiGLU MLP, both blocks residual.  A final non-parametric
LayerNorm, logits through the tied embedding, mean cross-entropy over
every position.  Departures from the paper: the LayerNorm epsilon is the
configuration's ``norm_eps`` (1e-6 as run; OLMo's released code uses
1e-5), and the weights are random from the seed.

Weights come in the system's layout: ``embed/embedding`` (V, D) and
per-layer leaves stacked on a leading axis (``layers/attn/wq`` (L, D,
H*hd), ``wk``, ``wv``, ``wo`` (L, H*hd, D), ``layers/mlp/w_gate``,
``w_up`` (L, D, F), ``w_down`` (L, F, D)).  LoRA factors
(``<w>.lora_a`` (L, D, r), ``<w>.lora_b`` (L, r, out)) replace each
target by ``w + alpha / r * a @ b``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Precision


def _layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd): rotate the pairs (i, i + hd/2) by position * freq_i."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _weight(attn: Dict[str, Any], name: str, i: int, lora: Optional[Dict[str, Any]],
            prec: Precision) -> torch.Tensor:
    w = attn[name][i]
    if lora is not None and f"{name}.lora_a" in attn:
        a, b = attn[f"{name}.lora_a"][i], attn[f"{name}.lora_b"][i]
        w = w + lora["alpha"] / lora["rank"] * prec.mm(a, b)
    return w


def loss(params: Dict[str, Any], batch, cfg: Dict[str, Any], prec: Precision,
         lora: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of a (tokens, labels) batch, both
    (B, S); every leaf of ``params`` float32."""
    tokens, labels = batch
    B, S = tokens.shape
    H, hd, eps = cfg["n_heads"], cfg["head_dim"], cfg["norm_eps"]
    x = F.embedding(tokens, params["embed"]["embedding"])
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    # One unbind a stacked leaf: indexing each layer would give every
    # layer's gradient the whole stack's size.
    attn, mlp = ({k: t.unbind(0) for k, t in params["layers"][g].items()}
                 for g in ("attn", "mlp"))

    def layer(x: torch.Tensor, i: int) -> torch.Tensor:
        h = _layer_norm(x, eps)
        q, k, v = (prec.mm(h, _weight(attn, n, i, lora, prec)).view(B, S, H, hd)
                   for n in ("wq", "wk", "wv"))
        q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
        s = prec.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        o = prec.mm(p, v.transpose(1, 2)).transpose(1, 2).reshape(B, S, H * hd)
        x = x + prec.mm(o, _weight(attn, "wo", i, lora, prec))
        h = _layer_norm(x, eps)
        g = F.silu(prec.mm(h, mlp["w_gate"][i])) * prec.mm(h, mlp["w_up"][i])
        return x + prec.mm(g, mlp["w_down"][i])

    # Each layer's activations are formed again in the backward: only its
    # input is kept, so that the float32 model trains in one card's memory.
    for i in range(cfg["n_layers"]):
        x = checkpoint(layer, x, i, use_reentrant=False) if x.requires_grad else layer(x, i)
    logits = prec.mm(_layer_norm(x, eps), params["embed"]["embedding"].t())
    return F.cross_entropy(logits.reshape(B * S, -1), labels.reshape(-1).long())
