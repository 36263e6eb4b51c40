"""Mamba-2 decoder-only LM (mamba2-130m family, arXiv:2405.21060), the
port of ``repro/models/ssm_lm.py``.

A stack of Mamba-2 blocks (no attention, no FFN — the SSD block subsumes
both roles), RMSNorm, tied embeddings.  Decode carries (conv, ssm) states
per layer; there is no KV cache, so decode is O(1) in context length.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from .layers import (
    Params,
    apply_norm,
    embed,
    final_logits,
    grad_dtype_guard,
    init_embedding,
    init_lm_head,
    init_norm,
    scan_layers,
    stack_layers,
)
from .mamba2 import init_mamba, init_mamba_cache, mamba_decode_step, mamba_forward


def init_ssm_lm(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    def layer_init(g):
        return {"norm": init_norm(cfg, cfg.d_model, device), "mamba": init_mamba(g, cfg, device)}

    p: Params = {
        "embed": init_embedding(gen, cfg, device),
        "layers": stack_layers(layer_init, gen, cfg.n_layers),
        "final_norm": init_norm(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_lm_head(gen, cfg, device)
    return p


def ssm_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    """Returns (logits, aux=0)."""
    x = embed(params["embed"], tokens).to(cfg.activation_dtype)

    def body(x, lp):
        h = apply_norm(lp["norm"], x, cfg.norm_type)
        return x + mamba_forward(lp["mamba"], h, cfg), None

    x, _ = scan_layers(body, x, params["layers"], cfg)
    logits = final_logits(params, grad_dtype_guard(x), cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def init_ssm_cache(cfg: ModelConfig, batch: int, device="cuda") -> Dict[str, torch.Tensor]:
    m = init_mamba_cache(cfg, batch, cfg.activation_dtype, device)
    L = cfg.n_layers
    return {
        "conv": torch.zeros((L,) + tuple(m["conv"].shape), dtype=cfg.activation_dtype,
                            device=device),
        "ssm": torch.zeros((L,) + tuple(m["ssm"].shape), dtype=torch.float32, device=device),
    }


def ssm_decode_step(params: Params, token: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cfg: ModelConfig):
    """One decode step; returns (logits, cache).  Context-length free.
    Each layer's conv window and SSM state are written into ``cache`` in
    place (the reference returns a new cache and donates the old one)."""
    x = embed(params["embed"], token).to(cfg.activation_dtype)

    def body(x, inp):
        lp, layer_cache = inp
        h = apply_norm(lp["norm"], x, cfg.norm_type)
        o, new = mamba_decode_step(lp["mamba"], h, layer_cache, cfg)
        layer_cache["conv"].copy_(new["conv"])
        layer_cache["ssm"].copy_(new["ssm"])
        return x + o, None

    x, _ = scan_layers(body, x, (params["layers"], cache), cfg)
    return final_logits(params, x, cfg), cache
