"""Shared model layers: norms, rotary embeddings, GQA attention (full /
chunked / sliding-window / cached-decode), SwiGLU MLP, embeddings.

The port of ``repro/models/layers.py``.  Parameters are nested dicts of
tensors keyed as in the reference, and per-layer parameters are stacked
along a leading axis (:func:`stack_layers`), so a reference tree carries
over leaf by leaf (:mod:`repro_torch.convert`).  :func:`scan_layers`
walks that axis with a Python loop where the reference runs ``lax.scan``.

These are the plain PyTorch versions.  The prefill's attention goes
through :func:`repro_torch.kernels.ops.flash_attention`, which launches the
hand-written kernel on a CUDA tensor and runs :func:`causal_attention` /
:func:`full_attention` here on a CPU tensor.

Precision follows the reference: scores are formed in fp32 from inputs
in the activation dtype, the softmax is fp32, and its weights are
rounded to q's dtype before the product with V.  The vocab projections
(:func:`unembed`, :func:`lm_head`) return fp32 logits.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..utils.tree import tree_flatten, tree_map, tree_unflatten

Params = Dict[str, Any]


def _normal(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
            dtype: torch.dtype, device) -> torch.Tensor:
    """Standard normal draws from ``gen`` times ``scale``, cast to
    ``dtype`` on ``device`` (the reference's ``(normal(k, s) * c).astype``).
    On the ``meta`` device nothing is drawn: an abstract init (shapes and
    dtypes only, as the reference's ``jax.eval_shape``) allocates nothing."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * scale
    return x.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, d: int, device="cuda") -> Params:
    """``{}`` for OLMo's non-parametric norm (the tree utilities keep an
    empty dict in place, as ``jax.tree`` does)."""
    if cfg.norm_type == "nonparametric":
        return {}
    p = {"scale": torch.ones((d,), dtype=cfg.weight_dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=cfg.weight_dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, norm_type: str, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if norm_type == "rmsnorm":
        rms = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        out = xf * rms * p["scale"].float()
    else:
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + eps)
        if norm_type == "layernorm":
            out = out * p["scale"].float() + p["bias"].float()
        # "nonparametric" (OLMo): no affine transform at all.
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                 # (D/2,)
    angles = positions[..., None].float() * freqs                # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale = 1.0 / math.sqrt(d)
    wdt = cfg.weight_dtype
    return {
        "wq": _normal(gen, (d, h * hd), scale, wdt, device),
        "wk": _normal(gen, (d, kv * hd), scale, wdt, device),
        "wv": _normal(gen, (d, kv * hd), scale, wdt, device),
        "wo": _normal(gen, (h * hd, d), scale, wdt, device),
    }


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, KV, G, D), k: (B, Sk, KV, D) -> (B, KV, G, Sq, Sk) fp32."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


def _gqa_combine(w: torch.Tensor, v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """w: (B, KV, G, Sq, Sk), v: (B, Sk, KV, D) -> (B, Sq, KV, G, D)."""
    return torch.einsum("bkgqs,bskd->bqkgd", w.to(dtype), v.to(dtype))


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sliding_window: Optional[int] = None,
    q_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Chunked causal (optionally sliding-window) attention.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D); H = KV * G.  Queries attend to
    keys at absolute positions <= their own; ``q_offset`` shifts query
    positions (used when Sq != Sk).  Loops over query chunks so peak
    memory is O(Sk * q_chunk) instead of O(Sq * Sk).
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D)
    kpos = torch.arange(Sk, device=q.device)

    def block(q_blk: torch.Tensor, qpos_blk: torch.Tensor) -> torch.Tensor:
        s = _gqa_scores(q_blk, k) * scale                      # (B,KV,G,cq,Sk)
        mask = qpos_blk[:, None] >= kpos[None, :]              # causal
        if sliding_window is not None:
            mask &= kpos[None, :] > (qpos_blk[:, None] - sliding_window)
        s = s.masked_fill(~mask, float("-inf"))
        w = torch.softmax(s, dim=-1)
        return _gqa_combine(w, v, q.dtype)                     # (B,cq,KV,G,D)

    qpos = q_offset + torch.arange(Sq, device=q.device)
    outs = [block(qg[:, i:i + q_chunk], qpos[i:i + q_chunk]) for i in range(0, Sq, q_chunk)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, D)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bidirectional (encoder / cross) attention. Shapes as above."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    s = _gqa_scores(qg, k) / math.sqrt(D)
    w = torch.softmax(s, dim=-1)
    return _gqa_combine(w, v, q.dtype).reshape(B, Sq, H, D)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
    *,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token decode against a KV cache.

    q: (B, 1, H, D); caches: (B, S, KV, D); pos: index of the new token
    (keys at indices <= pos are valid).

    With a sliding window and a cache much longer than the window, the
    window is sliced out of the cache first so score FLOPs/bytes scale
    with the window, not the cache length.
    """
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    pos = int(pos)
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, 1, KV, H // KV, D)

    if sliding_window is not None and S > 2 * sliding_window:
        W = sliding_window
        start = min(max(pos - (W - 1), 0), S - W)
        k_w = k_cache[:, start:start + W]
        v_w = v_cache[:, start:start + W]
        kpos = start + torch.arange(W, device=q.device)
        s = _gqa_scores(qg, k_w) * scale                       # (B,KV,G,1,W)
        valid = (kpos <= pos) & (kpos > pos - W)
        w = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)
        return _gqa_combine(w, v_w, q.dtype).reshape(B, 1, H, D)

    kpos = torch.arange(S, device=q.device)
    s = _gqa_scores(qg, k_cache) * scale                       # (B,KV,G,1,S)
    valid = kpos <= pos
    if sliding_window is not None:
        valid &= kpos > pos - sliding_window
    w = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)
    return _gqa_combine(w, v_cache, q.dtype).reshape(B, 1, H, D)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None,
             device="cuda") -> Params:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    wdt = cfg.weight_dtype
    return {
        "w_gate": _normal(gen, (d, f), 1.0 / math.sqrt(d), wdt, device),
        "w_up": _normal(gen, (d, f), 1.0 / math.sqrt(d), wdt, device),
        "w_down": _normal(gen, (f, d), 1.0 / math.sqrt(f), wdt, device),
    }


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU."""
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    return {"embedding": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                 cfg.weight_dtype, device)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table.  ``F.embedding``, not ``table[tokens]``: on the
    CPU the indexing's gradient (an accumulating ``index_put_``) sums
    repeated tokens in an order that changes from run to run, while the
    embedding's backward is the same sum in a fixed order."""
    return F.embedding(tokens, p["embedding"])


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits in fp32 (the reference's fp32-accumulated
    einsum: every bf16 value is an fp32 value, so the product is the
    same)."""
    return x.float() @ p["embedding"].float().t()


def init_lm_head(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    return {"w": _normal(gen, (cfg.d_model, cfg.vocab_size), 1.0 / math.sqrt(cfg.d_model),
                         cfg.weight_dtype, device)}


def lm_head(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x.float() @ p["w"].float()


def final_logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The LM's last step: the final norm, then the tied embedding or the
    head, in fp32."""
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return lm_head(params["lm_head"], x)


# ---------------------------------------------------------------------------
# Backward-dtype guard
# ---------------------------------------------------------------------------

class _GradDtypeGuard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_dtype_guard(x: torch.Tensor) -> torch.Tensor:
    """Identity whose cotangent is cast back to the primal dtype, so the
    fp32 loss does not turn the backward residual stream to fp32."""
    return _GradDtypeGuard.apply(x)


# ---------------------------------------------------------------------------
# Layer stacking / scanning
# ---------------------------------------------------------------------------

def stack_layers(init_fn: Callable[[torch.Generator], Params], gen: torch.Generator,
                 n_layers: int) -> Params:
    """Initialize n_layers homogeneous layers and stack each leaf on axis 0.
    Each layer is copied into the stacks as soon as it is drawn, so the
    stacks and one layer are all that is held at once (deepseek-moe-16b's
    27 MoE layers are 30 GB in bf16)."""
    leaves, treedef = tree_flatten(init_fn(gen))
    stacks = [torch.empty((n_layers,) + t.shape, dtype=t.dtype, device=t.device) for t in leaves]
    for i in range(n_layers):
        if i:
            leaves = tree_flatten(init_fn(gen))[0]
        for stack, t in zip(stacks, leaves):
            stack[i] = t
        del leaves
    return tree_unflatten(treedef, stacks)


def scan_layers(body, init, xs, cfg: ModelConfig):
    """``lax.scan`` over stacked layers as a Python loop: ``body(carry,
    x_i) -> (carry, y_i)`` for each slice ``x_i`` of every leaf of ``xs``
    along axis 0; returns ``(carry, ys)`` with the ``y_i`` stacked (``None``
    if the body returns ``None``).

    The reference adds FSDP gather and sequence-parallel constraints
    under a compute mesh with ``cfg.fsdp`` or ``cfg.sequence_parallel``
    set, and the plain scan otherwise.  The constraints choose where
    values live and change none of them; the port's layers run on one
    card's plain tensors, so with or without a compute mesh
    (``sharding/context.py``) this is the same loop.
    Multi-rank sharded execution (per-layer FSDP gathers, DTensor
    activations through the kernels) needs more than one card and is not
    ported (``ROADMAP.md``).  ``cfg`` is kept for the signature."""
    del cfg
    leaves, treedef = tree_flatten(xs)
    # One unbind a leaf, not an index a layer: the backward of ``a[i]`` is
    # a zero tensor of the whole stack with one slice filled, so n layers
    # would add n stack-sized gradients; unbind's backward stacks the n
    # slices once.  The slices are views (decode writes caches in place).
    slices = [leaf.unbind(0) for leaf in leaves]
    carry, ys = init, []
    for i in range(len(slices[0])):
        carry, y = body(carry, tree_unflatten(treedef, [s[i] for s in slices]))
        ys.append(y)
    if all(y is None for y in ys):
        return carry, None
    return carry, tree_map(lambda *a: torch.stack(a, dim=0), *ys)
