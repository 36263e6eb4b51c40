"""Decoder-only transformer LM for the dense (GQA) and VLM families, the
port of ``repro/models/transformer.py``.

Layers are homogeneous and stacked on a leading axis; :func:`scan_layers`
walks them.  KV caches are stacked per layer: (L, B, S_max, KV, HD).
The prefill's and the loss's attention is
:func:`repro_torch.kernels.ops.flash_attention` (the hand-written kernel
on a CUDA tensor, with its backward kernel when a gradient is needed;
``causal_attention`` on a CPU tensor); decode attends to the cache with
the plain ``decode_attention``, as the reference does.  ``lm_loss`` is
differentiable; ``grad_dtype_guard`` keeps the backward's residual
stream in the activations' dtype, as the reference's does.

The MoE family (``moe.py``, including MoE archs' ``first_k_dense``
layers) comes with ``ROADMAP.md`` queue 1, item 15's remainder.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import (
    Params,
    apply_mlp,
    apply_norm,
    apply_rope,
    decode_attention,
    embed,
    final_logits,
    grad_dtype_guard,
    init_attention,
    init_embedding,
    init_lm_head,
    init_mlp,
    init_norm,
    scan_layers,
    stack_layers,
)

MOE_TODO = "the MoE family: ROADMAP.md queue 1, item 15 (moe.py)"


def _no_moe(cfg: ModelConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(MOE_TODO)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_decoder_layer(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    return {
        "norm1": init_norm(cfg, cfg.d_model, device),
        "attn": init_attention(gen, cfg, device),
        "norm2": init_norm(cfg, cfg.d_model, device),
        "mlp": init_mlp(gen, cfg, device=device),
    }


def init_lm(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    _no_moe(cfg)
    p: Params = {"embed": init_embedding(gen, cfg, device)}
    p["layers"] = stack_layers(lambda g: _init_decoder_layer(g, cfg, device), gen, cfg.n_layers)
    p["final_norm"] = init_norm(cfg, cfg.d_model, device)
    if not cfg.tie_embeddings:
        p["lm_head"] = init_lm_head(gen, cfg, device)
    return p


# ---------------------------------------------------------------------------
# Layer forward
# ---------------------------------------------------------------------------

def _attn_block(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                sliding_window: Optional[int]):
    B, S, _ = x.shape
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    q = (h @ p["attn"]["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (h @ p["attn"]["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (h @ p["attn"]["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = ops.flash_attention(q, k, v, causal=True, window=sliding_window)
    o = o.reshape(B, S, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
    return x + o, (k, v)


def _decoder_layer_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                       sliding_window: Optional[int]):
    x, kv = _attn_block(p, x, cfg, positions, sliding_window)
    h = apply_norm(p["norm2"], x, cfg.norm_type)
    return x + apply_mlp(p["mlp"], h), kv


# ---------------------------------------------------------------------------
# Full forward (prefill)
# ---------------------------------------------------------------------------

def lm_forward(
    params: Params,
    tokens: torch.Tensor,                          # (B, S) integer
    cfg: ModelConfig,
    prefix_embeds: Optional[torch.Tensor] = None,  # (B, S_img, D) — VLM stub
    sliding_window: Optional[int] = None,
    return_cache: bool = False,
):
    """Returns (logits, aux_loss[, kv_cache]).

    `sliding_window` overrides cfg.sliding_window (None = full attention).
    With `return_cache`, also returns the stacked (k, v) of every layer —
    the prefill path.
    """
    _no_moe(cfg)
    sw = sliding_window if sliding_window is not None else cfg.sliding_window
    x = embed(params["embed"], tokens).to(cfg.activation_dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)

    def body(x, layer_p):
        x, kv = _decoder_layer_fwd(layer_p, x, cfg, positions, sw)
        return x, (kv if return_cache else None)

    x, kv = scan_layers(body, x, params["layers"], cfg)
    logits = final_logits(params, grad_dtype_guard(x), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not return_cache:
        return logits, aux
    return logits, aux, {"k": kv[0], "v": kv[1]}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  device="cuda") -> Dict[str, torch.Tensor]:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dt = cfg.activation_dtype
    if cfg.kv_cache_dtype == "int8":
        # int8 cache with per-(token, head) absmax scales.
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=dt, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=dt, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _quantize_kv(x: torch.Tensor):
    """x (B, 1, KV, HD) -> (int8 values, (B, 1, KV) scales)."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s.to(x.dtype)


def _dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return q.to(dtype) * s[..., None].to(dtype)


def _decode_layer(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int,
                  cfg: ModelConfig, sliding_window: Optional[int]) -> torch.Tensor:
    """One layer of one decode step.  ``cache`` holds this layer's slices
    (views into the stacked cache), written in place at ``pos``."""
    B = x.shape[0]
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    q = (h @ p["attn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
    k = (h @ p["attn"]["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
    v = (h @ p["attn"]["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
    posb = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        cache["k"][:, pos:pos + 1] = kq
        cache["v"][:, pos:pos + 1] = vq
        cache["k_scale"][:, pos:pos + 1] = ks
        cache["v_scale"][:, pos:pos + 1] = vs
        k_full = _dequantize_kv(cache["k"], cache["k_scale"], cfg.activation_dtype)
        v_full = _dequantize_kv(cache["v"], cache["v_scale"], cfg.activation_dtype)
    else:
        cache["k"][:, pos:pos + 1] = k
        cache["v"][:, pos:pos + 1] = v
        k_full, v_full = cache["k"], cache["v"]
    o = decode_attention(q, k_full, v_full, pos, sliding_window=sliding_window)
    x = x + o.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
    h2 = apply_norm(p["norm2"], x, cfg.norm_type)
    return x + apply_mlp(p["mlp"], h2)


def lm_decode_step(
    params: Params,
    token: torch.Tensor,      # (B, 1) integer
    cache: Dict[str, torch.Tensor],
    pos,                      # int (or 0-d tensor): write index of the new token
    cfg: ModelConfig,
    sliding_window: Optional[int] = None,
):
    """One decode step; returns (logits (B, 1, V), cache).

    The reference returns a new cache (and its serve loop donates the old
    one); here the new token's keys and values are written into ``cache``
    in place, and the same dict is returned."""
    _no_moe(cfg)
    sw = sliding_window if sliding_window is not None else cfg.sliding_window
    pos = int(pos)
    x = embed(params["embed"], token).to(cfg.activation_dtype)

    def body(x, inp):
        layer_p, layer_cache = inp
        return _decode_layer(layer_p, x, layer_cache, pos, cfg, sw), None

    x, _ = scan_layers(body, x, (params["layers"], cache), cfg)
    return final_logits(params, x, cfg), cache


# ---------------------------------------------------------------------------
# Loss (differentiable: on a card the attention's gradient is the
# flash_attention backward kernel)
# ---------------------------------------------------------------------------

def lm_loss(
    params: Params,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    cfg: ModelConfig,
    prefix_embeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    logits, aux = lm_forward(params, tokens, cfg, prefix_embeds=prefix_embeds)
    if prefix_embeds is not None:
        logits = logits[:, prefix_embeds.shape[1]:, :]
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return nll.mean() + cfg.router_aux_coef * aux
