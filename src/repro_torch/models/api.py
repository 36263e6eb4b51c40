"""Unified model API, the port of ``repro/models/api.py``: one dispatch
point over the architecture families.

Ported: ``dense``, ``vlm`` and ``ssm`` (init, loss, prefill, cache,
decode, parameter counts).  ``loss`` is differentiable; on a card the
``dense`` and ``vlm`` families train through the attention kernels'
backward, while ``ssm`` trains on the CPU only (the SSD scan kernel has
no backward yet and raises).  ``moe``, ``hybrid`` and ``encdec``
raise ``NotImplementedError`` naming their ``ROADMAP.md`` item.

Per-family inputs (all batched):
  prefill/loss : dense/ssm -> {tokens, labels}
                 vlm       -> {tokens, labels, patch_embeds}
  decode       : token (B, 1), pos, and the family's cache
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..utils.tree import tree_leaves
from . import ssm_lm as S
from . import transformer as T

Params = Dict[str, Any]

PORTED = ("dense", "vlm", "ssm")
_TODO = {
    "moe": T.MOE_TODO,
    "hybrid": "the hybrid family: ROADMAP.md queue 1, item 15 (hybrid.py)",
    "encdec": "the encoder-decoder family: ROADMAP.md queue 1, item 15 (encdec.py)",
}


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    cfg: ModelConfig

    def _family(self) -> str:
        a = self.cfg.arch_type
        if a in _TODO:
            raise NotImplementedError(_TODO[a])
        if a not in PORTED:
            raise ValueError(f"unknown arch_type {a!r}")
        return a

    # -- init ----------------------------------------------------------------
    def init(self, gen: torch.Generator, device="cuda") -> Params:
        if self._family() == "ssm":
            return S.init_ssm_lm(gen, self.cfg, device)
        return T.init_lm(gen, self.cfg, device)

    # -- loss ------------------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg, a = self.cfg, self._family()
        if a == "dense":
            return T.lm_loss(params, batch["tokens"], batch["labels"], cfg)
        if a == "vlm":
            return T.lm_loss(params, batch["tokens"], batch["labels"], cfg,
                             prefix_embeds=batch["patch_embeds"])
        logits, _ = S.ssm_forward(params, batch["tokens"], cfg)
        return _nll(logits, batch["labels"])

    # -- prefill (forward w/o loss; returns logits) ----------------------------
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg, a = self.cfg, self._family()
        if a == "dense":
            return T.lm_forward(params, batch["tokens"], cfg)[0]
        if a == "vlm":
            return T.lm_forward(params, batch["tokens"], cfg,
                                prefix_embeds=batch["patch_embeds"])[0]
        return S.ssm_forward(params, batch["tokens"], cfg)[0]

    # -- decode ----------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, device="cuda") -> Dict[str, torch.Tensor]:
        if self._family() == "ssm":
            return S.init_ssm_cache(self.cfg, batch, device)
        return T.init_kv_cache(self.cfg, batch, max_seq, device)

    def decode_step(self, params: Params, token: torch.Tensor, cache: Dict[str, torch.Tensor],
                    pos, sliding_window: Optional[int] = None):
        """(logits (B, 1, V), cache); the cache is updated in place."""
        if self._family() == "ssm":
            return S.ssm_decode_step(params, token, cache, self.cfg)
        return T.lm_decode_step(params, token, cache, pos, self.cfg,
                                sliding_window=sliding_window)

    # -- bookkeeping -----------------------------------------------------------
    def param_count(self, params: Params) -> int:
        return sum(int(x.numel()) for x in tree_leaves(params))

    def active_param_count(self, params: Params) -> int:
        """Active params per token; every ported family is dense, so all
        of them (the MoE's top_k share comes with the MoE family)."""
        self._family()
        return self.param_count(params)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0].mean()


def get_model(cfg: ModelConfig) -> ModelFamily:
    return ModelFamily(cfg)
