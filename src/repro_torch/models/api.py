"""Unified model API, the port of ``repro/models/api.py``: one dispatch
point over the architecture families.

Every family of the zoo is ported: ``dense``, ``moe``, ``vlm``, ``ssm``,
``hybrid`` and ``encdec`` (init, loss, prefill, cache, decode, parameter
counts).  ``loss`` is differentiable; on a card the ``dense``, ``moe``,
``vlm`` and ``encdec`` families train through the attention kernels'
backward, ``ssm`` through the SSD scan's and ``hybrid`` through both.

Per-family inputs (all batched):
  prefill/loss : dense/moe/ssm/hybrid -> {tokens, labels}
                 vlm       -> {tokens, labels, patch_embeds}
                 encdec    -> {frames, tokens, labels}
  decode       : token (B, 1), pos, and the family's cache
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..utils.tree import tree_leaves
from . import encdec as E
from . import hybrid as Hy
from . import ssm_lm as S
from . import transformer as T

Params = Dict[str, Any]

PORTED = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    cfg: ModelConfig

    def _family(self) -> str:
        a = self.cfg.arch_type
        if a not in PORTED:
            raise ValueError(f"unknown arch_type {a!r}")
        return a

    # -- init ----------------------------------------------------------------
    def init(self, gen: torch.Generator, device="cuda") -> Params:
        a = self._family()
        if a == "ssm":
            return S.init_ssm_lm(gen, self.cfg, device)
        if a == "hybrid":
            return Hy.init_hybrid_lm(gen, self.cfg, device)
        if a == "encdec":
            return E.init_encdec(gen, self.cfg, device)
        return T.init_lm(gen, self.cfg, device)

    # -- loss ------------------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg, a = self.cfg, self._family()
        if a in ("dense", "moe"):
            return T.lm_loss(params, batch["tokens"], batch["labels"], cfg)
        if a == "vlm":
            return T.lm_loss(params, batch["tokens"], batch["labels"], cfg,
                             prefix_embeds=batch["patch_embeds"])
        if a == "encdec":
            return E.encdec_loss(params, batch["frames"], batch["tokens"], batch["labels"], cfg)
        if a == "hybrid":
            logits, aux = Hy.hybrid_forward(params, batch["tokens"], cfg)
            return _nll(logits, batch["labels"]) + cfg.router_aux_coef * aux
        logits, _ = S.ssm_forward(params, batch["tokens"], cfg)
        return _nll(logits, batch["labels"])

    # -- prefill (forward w/o loss; returns logits) ----------------------------
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg, a = self.cfg, self._family()
        if a in ("dense", "moe"):
            return T.lm_forward(params, batch["tokens"], cfg)[0]
        if a == "vlm":
            return T.lm_forward(params, batch["tokens"], cfg,
                                prefix_embeds=batch["patch_embeds"])[0]
        if a == "encdec":
            memory = E.encode(params, batch["frames"], cfg)
            return E.decode_forward(params, batch["tokens"], memory, cfg)
        if a == "hybrid":
            return Hy.hybrid_forward(params, batch["tokens"], cfg)[0]
        return S.ssm_forward(params, batch["tokens"], cfg)[0]

    # -- decode ----------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, device="cuda") -> Dict[str, torch.Tensor]:
        a = self._family()
        if a == "ssm":
            return S.init_ssm_cache(self.cfg, batch, device)
        if a == "hybrid":
            return Hy.init_hybrid_cache(self.cfg, batch, max_seq, device)
        if a == "encdec":
            return E.init_encdec_cache(self.cfg, batch, max_seq, device)
        return T.init_kv_cache(self.cfg, batch, max_seq, device)

    def decode_step(self, params: Params, token: torch.Tensor, cache: Dict[str, torch.Tensor],
                    pos, sliding_window: Optional[int] = None):
        """(logits (B, 1, V), cache); the cache is updated in place."""
        a = self._family()
        if a == "ssm":
            return S.ssm_decode_step(params, token, cache, self.cfg)
        if a == "hybrid":
            return Hy.hybrid_decode_step(params, token, cache, pos, self.cfg,
                                         sliding_window=sliding_window)
        if a == "encdec":
            return E.encdec_decode_step(params, token, cache, pos, self.cfg)
        return T.lm_decode_step(params, token, cache, pos, self.cfg,
                                sliding_window=sliding_window)

    # -- bookkeeping -----------------------------------------------------------
    def param_count(self, params: Params) -> int:
        return sum(int(x.numel()) for x in tree_leaves(params))

    def active_param_count(self, params: Params) -> int:
        """Active params per token (MoE: top_k of n_experts), by the
        reference's rule: routed-expert leaves are those of 3 dimensions
        whose leading one is n_experts.  Stacked layers make them 4-D, so
        for the zoo's MoE configs this is the total, as the reference's is."""
        cfg = self.cfg
        self._family()
        total = self.param_count(params)
        if cfg.n_experts == 0:
            return total
        expert_leaves = sum(int(x.numel()) for x in tree_leaves(params)
                            if x.ndim == 3 and x.shape[0] == cfg.n_experts)
        active_frac = cfg.top_k / cfg.n_experts
        return int(total - expert_leaves + expert_leaves * active_frac)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0].mean()


def get_model(cfg: ModelConfig) -> ModelFamily:
    return ModelFamily(cfg)
