"""Whisper-style encoder-decoder (arXiv:2212.04356), the port of
``repro/models/encdec.py``.

The audio frontend (mel-spectrogram + 2x conv) is a stub, as in the
reference: the caller supplies frame embeddings (B, T_enc, d_model).  This
module is the transformer backbone: a bidirectional encoder over the
frames and a causal decoder with cross-attention.  Whisper uses LayerNorm
(with a bias) + GELU MLPs and MHA (n_kv_heads == n_heads), sinusoidal
encoder positions and a learned decoder position table; the head is tied
to the token embedding and its logits are fp32.

The prefill's and the loss's attention is
:func:`repro_torch.kernels.ops.flash_attention`: the encoder's self-
attention and the decoder's cross-attention with ``causal=False`` (the
cross-attention's queries are the decoder's S tokens, its keys the
encoder's T_enc frames, so Sk != Sq), the decoder's self-attention with
``causal=True``.  On a CUDA tensor that is the hand-written kernel, with
its backward kernel when a gradient is needed; on a CPU tensor the plain
``full_attention`` / ``causal_attention``.  Decode attends with the plain
``decode_attention`` (self) and ``full_attention`` (cross, against the
cross cache), as the reference does.  ``cfg.remat`` is ignored: autograd
keeps the activations.

Decode: a self-attention KV cache per decoder layer and the cross-
attention K/V of the encoder's output.  ``init_encdec_cache`` zeros both,
as the reference's does; ``decode_forward(..., return_cache=True)`` gives
the cross K/V of a prefill.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import (
    Params,
    _normal,
    apply_norm,
    decode_attention,
    embed,
    full_attention,
    grad_dtype_guard,
    init_attention,
    init_embedding,
    init_norm,
    scan_layers,
    stack_layers,
    unembed,
)


# ---------------------------------------------------------------------------
# GELU MLP (whisper flavour)
# ---------------------------------------------------------------------------

def _init_gelu_mlp(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    d, f = cfg.d_model, cfg.d_ff
    wdt = cfg.weight_dtype
    return {
        "w1": _normal(gen, (d, f), 1.0 / math.sqrt(d), wdt, device),
        "b1": torch.zeros((f,), dtype=wdt, device=device),
        "w2": _normal(gen, (f, d), 1.0 / math.sqrt(f), wdt, device),
        "b2": torch.zeros((d,), dtype=wdt, device=device),
    }


def _gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` is the tanh approximation by default."""
    return F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] + p["b2"]


def _sinusoidal(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) fp32: sines of the first half, cosines of the second."""
    pos = torch.arange(seq, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_encoder_layer(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    return {
        "norm1": init_norm(cfg, cfg.d_model, device),
        "attn": init_attention(gen, cfg, device),
        "norm2": init_norm(cfg, cfg.d_model, device),
        "mlp": _init_gelu_mlp(gen, cfg, device),
    }


def _init_decoder_layer(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    return {
        "norm1": init_norm(cfg, cfg.d_model, device),
        "self_attn": init_attention(gen, cfg, device),
        "norm_cross": init_norm(cfg, cfg.d_model, device),
        "cross_attn": init_attention(gen, cfg, device),
        "norm2": init_norm(cfg, cfg.d_model, device),
        "mlp": _init_gelu_mlp(gen, cfg, device),
    }


def init_encdec(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    return {
        "embed": init_embedding(gen, cfg, device),   # decoder tokens; tied head
        "dec_pos": _normal(gen, (cfg.max_decoder_seq, cfg.d_model), 0.01, cfg.weight_dtype,
                           device),
        "encoder": stack_layers(lambda g: _init_encoder_layer(g, cfg, device), gen,
                                cfg.n_encoder_layers),
        "enc_final_norm": init_norm(cfg, cfg.d_model, device),
        "decoder": stack_layers(lambda g: _init_decoder_layer(g, cfg, device), gen,
                                cfg.n_layers),
        "final_norm": init_norm(cfg, cfg.d_model, device),
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, w: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, d) @ (d, n * hd) -> (B, S, n, hd)."""
    return (x @ w).reshape(x.shape[0], x.shape[1], n, hd)


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, T_enc, d_model) stub embeddings -> encoder memory."""
    B, T, D = frames.shape
    act = cfg.activation_dtype
    x = frames.to(act) + _sinusoidal(T, D, frames.device).to(act)

    def body(x, lp):
        h = apply_norm(lp["norm1"], x, cfg.norm_type)
        a = lp["attn"]
        o = ops.flash_attention(_heads(h, a["wq"], cfg.n_heads, cfg.hd),
                                _heads(h, a["wk"], cfg.n_kv_heads, cfg.hd),
                                _heads(h, a["wv"], cfg.n_kv_heads, cfg.hd), causal=False)
        x = x + o.reshape(B, T, cfg.n_heads * cfg.hd) @ a["wo"]
        h2 = apply_norm(lp["norm2"], x, cfg.norm_type)
        return x + _gelu_mlp(lp["mlp"], h2), None

    x, _ = scan_layers(body, x, params["encoder"], cfg)
    return apply_norm(params["enc_final_norm"], x, cfg.norm_type)


# ---------------------------------------------------------------------------
# Decoder forward (train / prefill)
# ---------------------------------------------------------------------------

def decode_forward(params: Params, tokens: torch.Tensor, memory: torch.Tensor,
                   cfg: ModelConfig, return_cache: bool = False):
    """Logits (B, S, V) fp32 of ``tokens`` (B, S) over the encoder's
    ``memory`` (B, T_enc, d); with ``return_cache`` also the stacked
    self-attention K/V and cross-attention K/V of every layer."""
    B, S = tokens.shape
    T = memory.shape[1]
    x = embed(params["embed"], tokens).to(cfg.activation_dtype)
    x = x + params["dec_pos"][:S].to(x.dtype)[None]

    def body(x, lp):
        h = apply_norm(lp["norm1"], x, cfg.norm_type)
        a = lp["self_attn"]
        q = _heads(h, a["wq"], cfg.n_heads, cfg.hd)
        k = _heads(h, a["wk"], cfg.n_kv_heads, cfg.hd)
        v = _heads(h, a["wv"], cfg.n_kv_heads, cfg.hd)
        o = ops.flash_attention(q, k, v, causal=True)
        x = x + o.reshape(B, S, cfg.n_heads * cfg.hd) @ a["wo"]

        hc = apply_norm(lp["norm_cross"], x, cfg.norm_type)
        c = lp["cross_attn"]
        qc = _heads(hc, c["wq"], cfg.n_heads, cfg.hd)
        kc = (memory @ c["wk"]).reshape(B, T, cfg.n_kv_heads, cfg.hd)
        vc = (memory @ c["wv"]).reshape(B, T, cfg.n_kv_heads, cfg.hd)
        oc = ops.flash_attention(qc, kc, vc, causal=False)
        x = x + oc.reshape(B, S, cfg.n_heads * cfg.hd) @ c["wo"]

        h2 = apply_norm(lp["norm2"], x, cfg.norm_type)
        return x + _gelu_mlp(lp["mlp"], h2), ((k, v, kc, vc) if return_cache else None)

    x, caches = scan_layers(body, x, params["decoder"], cfg)
    x = grad_dtype_guard(x)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    logits = unembed(params["embed"], x)
    if not return_cache:
        return logits
    k, v, kc, vc = caches
    return logits, {"k_self": k, "v_self": v, "k_cross": kc, "v_cross": vc}


def encdec_loss(params: Params, frames: torch.Tensor, tokens: torch.Tensor,
                labels: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    memory = encode(params, frames, cfg)
    logits = decode_forward(params, tokens, memory, cfg)
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0].mean()


# ---------------------------------------------------------------------------
# Decode (single token)
# ---------------------------------------------------------------------------

def init_encdec_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device="cuda") -> Dict[str, torch.Tensor]:
    dt = cfg.activation_dtype
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    return {
        "k_self": torch.zeros((L, batch, max_seq, KV, hd), dtype=dt, device=device),
        "v_self": torch.zeros((L, batch, max_seq, KV, hd), dtype=dt, device=device),
        "k_cross": torch.zeros((L, batch, cfg.encoder_seq, KV, hd), dtype=dt, device=device),
        "v_cross": torch.zeros((L, batch, cfg.encoder_seq, KV, hd), dtype=dt, device=device),
    }


def encdec_decode_step(params: Params, token: torch.Tensor, cache: Dict[str, torch.Tensor],
                       pos, cfg: ModelConfig):
    """One decode step; returns (logits (B, 1, V), cache).  The new
    token's self-attention K/V are written into ``cache`` in place at
    ``pos`` (the reference returns a new cache); the cross K/V are read."""
    B = token.shape[0]
    pos = int(pos)
    x = embed(params["embed"], token).to(cfg.activation_dtype)
    x = x + params["dec_pos"][pos:pos + 1].to(x.dtype)[None]

    def body(x, inp):
        lp, ks, vs, kc, vc = inp
        h = apply_norm(lp["norm1"], x, cfg.norm_type)
        a = lp["self_attn"]
        ks[:, pos:pos + 1] = _heads(h, a["wk"], cfg.n_kv_heads, cfg.hd)
        vs[:, pos:pos + 1] = _heads(h, a["wv"], cfg.n_kv_heads, cfg.hd)
        o = decode_attention(_heads(h, a["wq"], cfg.n_heads, cfg.hd), ks, vs, pos)
        x = x + o.reshape(B, 1, cfg.n_heads * cfg.hd) @ a["wo"]

        hc = apply_norm(lp["norm_cross"], x, cfg.norm_type)
        c = lp["cross_attn"]
        oc = full_attention(_heads(hc, c["wq"], cfg.n_heads, cfg.hd), kc, vc)
        x = x + oc.reshape(B, 1, cfg.n_heads * cfg.hd) @ c["wo"]

        h2 = apply_norm(lp["norm2"], x, cfg.norm_type)
        return x + _gelu_mlp(lp["mlp"], h2), None

    x, _ = scan_layers(body, x, (params["decoder"], cache["k_self"], cache["v_self"],
                                 cache["k_cross"], cache["v_cross"]), cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return unembed(params["embed"], x), cache
