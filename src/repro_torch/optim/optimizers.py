"""Optimizers: AdamW and SGD-momentum over trees of tensors.

The port of ``repro/optim/optimizers.py``: the same defaults (AdamW
``b2=0.95``, ``weight_decay=0.1``), the same update rule with the weight
decay added inside ``delta``, the update math in fp32 whatever the
parameter or state dtype.  ``torch.optim`` is not used: its AdamW applies
the decay outside the Adam step, which is another rule.

``update`` is out of place: it returns new parameter and state trees and
leaves its inputs untouched, as the reference's pure functions do.  The
FL server hands the same global tree to every client, so an in-place
step would start the second client from the first one's weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.tree import tree_flatten, tree_map, tree_unflatten

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _state_dtype(name: str) -> torch.dtype:
    try:
        return _STATE_DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown state dtype {name!r}") from None


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"
    schedule: Optional[Callable[[int], float]] = None

    def init(self, params: Any) -> AdamWState:
        dt = _state_dtype(self.state_dtype)
        zeros = lambda p: torch.zeros_like(p, dtype=dt)  # noqa: E731
        return AdamWState(step=0, m=tree_map(zeros, params), v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any) -> Tuple[Any, AdamWState]:
        step = state.step + 1
        lr = self.learning_rate if self.schedule is None else float(self.schedule(step))
        b1, b2 = self.b1, self.b2
        dt = _state_dtype(self.state_dtype)
        # Bias corrections in fp32, as the reference computes them.
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))

        p_leaves, treedef = tree_flatten(params)
        g_leaves, m_leaves, v_leaves = (
            tree_flatten(t)[0] for t in (grads, state.m, state.v)
        )
        new_p, new_m, new_v = [], [], []
        for g, m, v, p in zip(g_leaves, m_leaves, v_leaves, p_leaves):
            gf = g.float()
            mf = b1 * m.float() + (1 - b1) * gf
            vf = b2 * v.float() + (1 - b2) * gf * gf
            delta = (mf / c1) / (torch.sqrt(vf / c2) + self.eps) + self.weight_decay * p.float()
            new_p.append((p.float() - lr * delta).to(p.dtype))
            new_m.append(mf.to(dt))
            new_v.append(vf.to(dt))
        return tree_unflatten(treedef, new_p), AdamWState(
            step=step, m=tree_unflatten(treedef, new_m), v=tree_unflatten(treedef, new_v)
        )


class SGDState(NamedTuple):
    step: int
    momentum: Any


@dataclasses.dataclass(frozen=True)
class SGDMomentum:
    learning_rate: float = 0.01
    momentum: float = 0.9
    state_dtype: str = "float32"

    def init(self, params: Any) -> SGDState:
        dt = _state_dtype(self.state_dtype)
        return SGDState(step=0, momentum=tree_map(lambda p: torch.zeros_like(p, dtype=dt), params))

    @torch.no_grad()
    def update(self, grads: Any, state: SGDState, params: Any) -> Tuple[Any, SGDState]:
        p_leaves, treedef = tree_flatten(params)
        g_leaves = tree_flatten(grads)[0]
        b_leaves = tree_flatten(state.momentum)[0]
        new_p, new_b = [], []
        for g, buf, p in zip(g_leaves, b_leaves, p_leaves):
            mf = self.momentum * buf.float() + g.float()
            new_p.append((p.float() - self.learning_rate * mf).to(p.dtype))
            new_b.append(mf.to(buf.dtype))
        return tree_unflatten(treedef, new_p), SGDState(
            step=state.step + 1, momentum=tree_unflatten(treedef, new_b)
        )


def make_optimizer(name: str, learning_rate: float, state_dtype: str = "float32", **kw):
    if name == "adamw":
        return AdamW(learning_rate=learning_rate, state_dtype=state_dtype, **kw)
    if name == "sgdm":
        return SGDMomentum(learning_rate=learning_rate, state_dtype=state_dtype, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
