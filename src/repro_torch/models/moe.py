"""Mixture-of-Experts layer, the port of ``repro/models/moe.py``: top-k
token-choice routing with capacity-buffer dispatch.

The tokens are viewed as G consecutive groups of T / G, G the "data"
axis size of the compute mesh (``sharding/context.py``) when one is set
and divides T, else 1, as the reference does.  Each group routes its own
tokens into private capacity buffers: slots are counted within the group
and the capacity follows from T / G, so G changes which assignments drop.
The reference's sharding constraints (``cst``) change no value; on the
port's plain tensors they are the identity and are left out.

Routing follows the reference step for step: an fp32 softmax router, the
top k experts a token with their gates renormalized to sum to 1, a
capacity of ``max(ceil(K·T/E·cf), min(T, 8))`` slots an expert, and each
assignment's slot from the exclusive cumulative count of its expert in
the flattened (token, k) order, so earlier assignments win a full expert
and later ones drop.  A dropped assignment contributes zero.  The experts
are SwiGLUs batched over (E, G·C, D) buffers; the shared experts
(deepseek-moe) a dense SwiGLU added to every token; the auxiliary loss
the Switch load-balance term ``E·Σ frac·mean_prob / K``.

Nothing here accumulates through atomics on the card, so two runs give
the same bits, forward and backward:
- a token's K copies are an ``expand`` of its row, whose gradient is a
  sum over K;
- the dispatch writes each kept assignment's row to its (expert, slot),
  which no other kept assignment holds, and the combine reads it back
  (:class:`_ToSlots` and :class:`_FromSlots`, each the other's
  transpose); dropped assignments go to a spare row that is thrown away;
- the combine sums each token's K weighted rows in one reduction over K,
  taken in fp32 and rounded once to the activations' dtype.  The
  reference's scatter-add rounds after each of the K adds, so in bf16 the
  two differ by those roundings; in fp32 only by the order of the adds.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding.context import axis_sizes, current_compute_mesh
from .layers import Params, _normal, apply_mlp, init_mlp


def init_moe(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None,
             device="cuda") -> Params:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    e = cfg.n_experts
    wdt = cfg.weight_dtype
    p: Params = {
        "router": _normal(gen, (d, e), 1.0 / math.sqrt(d), torch.float32, device),
        "w_gate": _normal(gen, (e, d, f), 1.0 / math.sqrt(d), wdt, device),
        "w_up": _normal(gen, (e, d, f), 1.0 / math.sqrt(d), wdt, device),
        "w_down": _normal(gen, (e, f, d), 1.0 / math.sqrt(f), wdt, device),
    }
    if cfg.n_shared_experts > 0:
        # Shared experts are a dense SwiGLU of width n_shared * f, always on.
        p["shared"] = init_mlp(gen, cfg, d_ff=cfg.n_shared_experts * f, device=device)
    return p


def router_probs(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., E) softmax router probabilities in fp32."""
    return torch.softmax(x.float() @ p["router"], dim=-1)


class Routing(NamedTuple):
    probs: torch.Tensor        # (T, E) fp32
    gates: torch.Tensor        # (T, K) fp32, renormalized
    expert_idx: torch.Tensor   # (T, K) int64
    pos: torch.Tensor          # (T·K,) slot in its expert, before the capacity cut
    keep: torch.Tensor         # (T·K,) bool: pos < capacity
    capacity: int


def capacity_for(cfg: ModelConfig, n_tokens: int, capacity_factor: float) -> int:
    """Slots an expert; the floor keeps small decode batches drop-free."""
    capacity = int(math.ceil(cfg.top_k * n_tokens / cfg.n_experts * capacity_factor))
    return max(capacity, min(n_tokens, 8))


def route(p: Params, x: torch.Tensor, cfg: ModelConfig, capacity_factor: float,
          groups: int = 1) -> Routing:
    """x (T, D) -> each token's experts, gates and capacity slots.  With
    ``groups`` G the tokens are G consecutive groups of T / G: an
    assignment's slot counts only its group's earlier assignments, and the
    capacity is a group's."""
    E, K = cfg.n_experts, cfg.top_k
    probs = router_probs(p, x)
    gates, expert_idx = torch.topk(probs, K, dim=-1)
    # deepseek-moe renormalizes the top-k gates to sum to 1.
    gates = gates / gates.sum(-1, keepdim=True)
    capacity = capacity_for(cfg, x.shape[0] // groups, capacity_factor)
    flat = expert_idx.reshape(-1)
    # (E, A), so the count runs along the inner dim: on an H100, PyTorch's
    # scan along an outer dim of A = 65,536 rows took 353 ms of a 437 ms
    # granite-moe-1b-a400m (4, 2048) prefill.  A group's assignments are a
    # contiguous run of A / G.
    onehot = F.one_hot(flat, E).t().contiguous().view(E, groups, -1)
    pos_in_expert = (onehot.cumsum(2) - onehot).view(E, -1)       # exclusive
    pos = pos_in_expert.gather(0, flat[None, :])[0]
    return Routing(probs, gates, expert_idx, pos, pos < capacity, capacity)


def _put(rows: torch.Tensor, spare: torch.Tensor, n: int) -> torch.Tensor:
    """(A, D) -> (n, D): row a to slot ``spare[a]`` where that is below n,
    the rest to a spare row n that is dropped.  No two rows below n share a
    slot, so the plain indexed write gives each slot its one row."""
    out = rows.new_zeros((n + 1, rows.shape[1]))
    out[spare] = rows
    return out[:n]


def _take(slots: torch.Tensor, spare: torch.Tensor) -> torch.Tensor:
    """(n, D) -> (A, D): row a is slot ``spare[a]``, zero where that is n."""
    n = slots.shape[0]
    kept = spare < n
    return slots[torch.where(kept, spare, 0)] * kept[:, None].to(slots.dtype)


class _ToSlots(torch.autograd.Function):
    """The dispatch, ``_put``; its gradient is ``_take``."""

    @staticmethod
    def forward(ctx, rows, spare, n):
        ctx.save_for_backward(spare)
        return _put(rows, spare, n)

    @staticmethod
    def backward(ctx, g):
        (spare,) = ctx.saved_tensors
        return _take(g, spare), None, None


class _FromSlots(torch.autograd.Function):
    """The combine's read, ``_take``; its gradient is ``_put`` (a slot has
    at most one reader, so nothing is accumulated)."""

    @staticmethod
    def forward(ctx, slots, spare):
        ctx.save_for_backward(spare)
        ctx.n = slots.shape[0]
        return _take(slots, spare)

    @staticmethod
    def backward(ctx, g):
        (spare,) = ctx.saved_tensors
        return _put(g, spare, ctx.n), None


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss). Overflowing tokens fall through to
    the residual path (their expert contribution is zero)."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    mesh = current_compute_mesh()
    G = 1
    if mesh is not None and T % axis_sizes(mesh).get("data", 1) == 0:
        G = axis_sizes(mesh).get("data", 1)

    r = route(p, xt, cfg, capacity_factor, G)
    C = r.capacity
    # Each assignment's row of the (E, G·C, D) buffers, expert e's slots of
    # group g at e·G·C + g·C; E·G·C for a dropped one.
    group = torch.arange(T * K, device=x.device) // (T * K // G)
    spare = torch.where(r.keep, r.expert_idx.reshape(-1) * (G * C) + group * C + r.pos,
                        E * G * C)

    copies = xt[:, None, :].expand(T, K, D).reshape(T * K, D)     # token of each assignment
    expert_in = _ToSlots.apply(copies, spare, E * G * C).view(E, G * C, D)

    # Expert FFN (SwiGLU) batched over the experts.
    h = F.silu(torch.bmm(expert_in, p["w_gate"])) * torch.bmm(expert_in, p["w_up"])
    expert_out = torch.bmm(h, p["w_down"])                        # (E, G·C, D)

    assign_out = _FromSlots.apply(expert_out.view(E * G * C, D), spare)
    weighted = assign_out * r.gates.reshape(T * K, 1).to(x.dtype)
    y = weighted.view(T, K, D).sum(1, dtype=torch.float32).to(x.dtype)

    if "shared" in p:
        y = y + apply_mlp(p["shared"], xt)

    # Switch-style load-balance loss: E * sum_e fraction_e * prob_e.
    frac = F.one_hot(r.expert_idx, E).sum(1).float().mean(0)
    mean_prob = r.probs.mean(0)
    aux = E * torch.sum(frac * mean_prob) / K
    return y.reshape(B, S, D), aux.float()
