"""Jamba-style hybrid (arXiv:2403.19887, Jamba 1.5), the port of
``repro/models/hybrid.py``: attention interleaved 1:(attn_period-1) with
Mamba-2 blocks, MoE in place of the dense FFN on every ``moe_every``-th
layer.

The layer pattern repeats every lcm(attn_period, moe_every) layers (Jamba:
8 — seven Mamba blocks, then one attention block; MoE on every second
layer), so the parameters are stacked per *superblock* of that many
layers (``superblocks/l{i}/{norm1,norm2,mixer,ffn}``, each leaf with a
leading superblock axis) and :func:`scan_layers` walks the superblocks.

The prefill's and the loss's attention is
:func:`repro_torch.kernels.ops.flash_attention` and the Mamba layers' scan
:func:`repro_torch.kernels.ops.ssd_scan` (through
:func:`.mamba2.mamba_forward`): the hand-written kernels on a CUDA tensor,
with their backward kernels when a gradient is needed, the plain versions
on a CPU tensor.  The MoE layers are :mod:`.moe`, their routers' auxiliary
losses summed over the model.  ``cfg.remat`` is ignored: autograd keeps the
activations.

Decode carries a heterogeneous cache: per superblock, the stacked Mamba
(conv, ssm) states of its Mamba slots and the K/V caches of its attention
slots.  It attends with the plain ``decode_attention`` and steps the SSM
with ``mamba_decode_step``, as the reference does, so it launches no
kernel; the cache is written in place.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

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
from .mamba2 import init_mamba, init_mamba_cache, mamba_decode_step, mamba_forward
from .moe import apply_moe, init_moe


def _superblock_len(cfg: ModelConfig) -> int:
    return (cfg.attn_period * cfg.moe_every) // math.gcd(cfg.attn_period, cfg.moe_every)


def _layer_kinds(cfg: ModelConfig, sb_len: int) -> List[Tuple[bool, bool]]:
    """Per-layer (is_attn, is_moe) pattern inside one superblock."""
    kinds = []
    for i in range(sb_len):
        is_attn = (i % cfg.attn_period) == (cfg.attn_period - 1)
        is_moe = cfg.n_experts > 0 and (i % cfg.moe_every) == (cfg.moe_every - 1)
        kinds.append((is_attn, is_moe))
    return kinds


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_superblock(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    out: Params = {}
    for i, (is_attn, is_moe) in enumerate(_layer_kinds(cfg, _superblock_len(cfg))):
        out[f"l{i}"] = {
            "norm1": init_norm(cfg, cfg.d_model, device),
            "norm2": init_norm(cfg, cfg.d_model, device),
            "mixer": init_attention(gen, cfg, device) if is_attn else init_mamba(gen, cfg, device),
            "ffn": init_moe(gen, cfg, device=device) if is_moe else init_mlp(gen, cfg,
                                                                             device=device),
        }
    return out


def init_hybrid_lm(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    sb_len = _superblock_len(cfg)
    assert cfg.n_layers % sb_len == 0, (
        f"n_layers {cfg.n_layers} not a multiple of super-block {sb_len}"
    )
    p: Params = {
        "embed": init_embedding(gen, cfg, device),
        "superblocks": stack_layers(lambda g: _init_superblock(g, cfg, device), gen,
                                    cfg.n_layers // sb_len),
        "final_norm": init_norm(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_lm_head(gen, cfg, device)
    return p


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """The attention mixer's rotated q (B, S, H, hd) and k, v (B, S, KV, hd)."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    return (apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta),
            v)


def _attn_mixer(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                sw: Optional[int]) -> torch.Tensor:
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    o = ops.flash_attention(q, k, v, causal=True, window=sw)
    return o.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig, is_moe: bool):
    """(y, aux): the layer's MoE with its router loss, or its MLP and None."""
    if is_moe:
        return apply_moe(p, h, cfg)
    return apply_mlp(p, h), None


def hybrid_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   sliding_window: Optional[int] = None):
    """Returns (logits (B, S, V) fp32, aux): aux is the routers' load-balance
    loss summed over the MoE layers."""
    sw = sliding_window if sliding_window is not None else cfg.sliding_window
    x = embed(params["embed"], tokens).to(cfg.activation_dtype)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    kinds = _layer_kinds(cfg, _superblock_len(cfg))

    def sb_body(carry, sb):
        x, aux = carry
        for i, (is_attn, is_moe) in enumerate(kinds):
            lp = sb[f"l{i}"]
            h = apply_norm(lp["norm1"], x, cfg.norm_type)
            if is_attn:
                x = x + _attn_mixer(lp["mixer"], h, cfg, positions, sw)
            else:
                x = x + mamba_forward(lp["mixer"], h, cfg)
            y, a = _ffn(lp["ffn"], apply_norm(lp["norm2"], x, cfg.norm_type), cfg, is_moe)
            if a is not None:
                aux = aux + a
            x = x + y
        return (x, aux), None

    (x, aux), _ = scan_layers(
        sb_body, (x, torch.zeros((), dtype=torch.float32, device=x.device)),
        params["superblocks"], cfg)
    return final_logits(params, grad_dtype_guard(x), cfg), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_hybrid_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """Stacked per-superblock caches: Mamba states for every non-attention
    slot, one KV cache per attention slot."""
    sb_len = _superblock_len(cfg)
    n_sb = cfg.n_layers // sb_len
    n_mamba = sum(1 for a, _ in _layer_kinds(cfg, sb_len) if not a)
    n_attn = sb_len - n_mamba
    dt = cfg.activation_dtype
    m = init_mamba_cache(cfg, batch, dt, "meta")
    kv = (n_sb, n_attn, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {
        "conv": torch.zeros((n_sb, n_mamba) + tuple(m["conv"].shape), dtype=dt, device=device),
        "ssm": torch.zeros((n_sb, n_mamba) + tuple(m["ssm"].shape), dtype=torch.float32,
                           device=device),
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
    }


def hybrid_decode_step(params: Params, token: torch.Tensor, cache: Dict[str, torch.Tensor],
                       pos, cfg: ModelConfig, sliding_window: Optional[int] = None):
    """One decode step of ``token`` (B, 1) at write index ``pos``; returns
    (logits (B, 1, V), cache).  Each Mamba slot's conv window and SSM state
    and each attention slot's new K/V are written into ``cache`` in place
    (the reference returns a new cache)."""
    sw = sliding_window if sliding_window is not None else cfg.sliding_window
    pos = int(pos)
    x = embed(params["embed"], token).to(cfg.activation_dtype)
    B = x.shape[0]
    kinds = _layer_kinds(cfg, _superblock_len(cfg))
    posb = torch.full((B, 1), pos, dtype=torch.long, device=x.device)

    def sb_body(x, inp):
        sb, conv_c, ssm_c, k_c, v_c = inp
        mi = ai = 0   # the Mamba and the attention slot indices
        for i, (is_attn, is_moe) in enumerate(kinds):
            lp = sb[f"l{i}"]
            h = apply_norm(lp["norm1"], x, cfg.norm_type)
            if is_attn:
                p = lp["mixer"]
                q, k, v = _qkv(p, h, cfg, posb)
                k_c[ai][:, pos:pos + 1] = k
                v_c[ai][:, pos:pos + 1] = v
                o = decode_attention(q, k_c[ai], v_c[ai], pos, sliding_window=sw)
                x = x + o.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"]
                ai += 1
            else:
                o, new = mamba_decode_step(lp["mixer"], h, {"conv": conv_c[mi], "ssm": ssm_c[mi]},
                                           cfg)
                conv_c[mi].copy_(new["conv"])
                ssm_c[mi].copy_(new["ssm"])
                x = x + o
                mi += 1
            y, _ = _ffn(lp["ffn"], apply_norm(lp["norm2"], x, cfg.norm_type), cfg, is_moe)
            x = x + y
        return x, None

    x, _ = scan_layers(sb_body, x, (params["superblocks"], cache["conv"], cache["ssm"],
                                    cache["k"], cache["v"]), cfg)
    return final_logits(params, x, cfg), cache
