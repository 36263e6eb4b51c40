"""Optimizers: AdamW and SGD-momentum over trees of tensors.

The port of ``repro/optim/optimizers.py``: the same defaults (AdamW
``b2=0.95``, ``weight_decay=0.1``), the same update rule with the weight
decay added inside ``delta``, the update math in fp32 whatever the
parameter or state dtype.  ``torch.optim`` is not used: its AdamW applies
the decay outside the Adam step, which is another rule.  AdamW's update is
``kernels.ops.adamw_step``: on CUDA leaves one hand-written kernel pass a
(parameter dtype, state dtype) group, on CPU and ``meta`` leaves its plain
version, bit for bit the same rule.

``update`` is out of place: it returns new parameter and state trees and
leaves its inputs untouched, as the reference's pure functions do.  The
FL server hands the same global tree to every client, so an in-place
step would start the second client from the first one's weights.

:class:`MaskedOptimizer` (``masked``) freezes every leaf its selector
does not match, with the reference's result; it keeps no state and reads
no gradient for a frozen leaf, and :meth:`MaskedOptimizer.trainable_mask`
tells a caller which gradients it needs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..utils import spans
from ..utils.tree import keystr, tree_flatten, tree_flatten_with_path, tree_map, tree_unflatten

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
        # Bias corrections in fp32, as the reference computes them.
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(step))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(step))

        with spans.span("optim.update"):
            p_leaves, treedef = tree_flatten(params)
            g_leaves, m_leaves, v_leaves = (
                tree_flatten(t)[0] for t in (grads, state.m, state.v)
            )
            new_p, new_m, new_v = ops.adamw_step(
                p_leaves, g_leaves, m_leaves, v_leaves, lr=lr, b1=self.b1, b2=self.b2,
                eps=self.eps, weight_decay=self.weight_decay, c1=c1, c2=c2)
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


@dataclasses.dataclass(frozen=True)
class MaskedOptimizer:
    """Freeze every leaf the selector does not match.

    Wraps an optimizer with the AdamW/SGDM ``init``/``update`` shape that
    updates each leaf on its own (AdamW and SGDMomentum do).  The rule is
    the reference's: a masked-out leaf comes back verbatim, a trainable
    leaf takes the inner update.  The adapter-FL use:
    ``masked(AdamW(...), ".lora_")`` trains only injected LoRA factors.

    ``trainable`` is a substring matched against each leaf's path in the
    reference's ``jax.tree_util.keystr`` form (``"['fc0']['w.lora_a']"``,
    see :func:`~repro_torch.utils.tree.keystr`) or a callable
    ``path_str -> bool``.

    Unlike the reference, which runs the inner optimizer over every leaf
    with zero gradients for the frozen ones and then throws their update
    away, the inner optimizer here sees only the trainable leaves: its
    state holds nothing for a frozen leaf, and a gradient tree may hold
    ``None`` for one (it is never read).  The parameters that come back
    are the same; for a frozen 1.2 B-parameter base under rank-2 adapters
    this saves ~9.4 GB of fp32 AdamW state and a pass over the base a
    step.
    """

    inner: Any
    trainable: Any

    def trainable_mask(self, params: Any) -> Any:
        """A tree of bools, True where the leaf trains."""
        sel = self.trainable
        if callable(sel):
            match = sel
        else:
            needle = str(sel)
            match = lambda path: needle in path  # noqa: E731
        pairs, treedef = tree_flatten_with_path(params)
        return tree_unflatten(treedef, [bool(match(keystr(path))) for path, _ in pairs])

    def _trained(self, params: Any) -> List[int]:
        return [i for i, m in enumerate(tree_flatten(self.trainable_mask(params))[0]) if m]

    def init(self, params: Any) -> Any:
        leaves = tree_flatten(params)[0]
        return self.inner.init([leaves[i] for i in self._trained(params)])

    def update(self, grads: Any, state: Any, params: Any) -> Tuple[Any, Any]:
        p_leaves, treedef = tree_flatten(params)
        g_leaves = _grad_leaves(grads)
        if len(g_leaves) != len(p_leaves):
            raise ValueError(f"{len(g_leaves)} gradients for {len(p_leaves)} parameters")
        idx = self._trained(params)
        new_sub, new_state = self.inner.update(
            [g_leaves[i] for i in idx], state, [p_leaves[i] for i in idx])
        out = list(p_leaves)
        for i, leaf in zip(idx, new_sub):
            out[i] = leaf
        return tree_unflatten(treedef, out), new_state


def _grad_leaves(grads: Any) -> List[Any]:
    """The leaves of a gradient tree in ``tree_flatten`` order, ``None``
    kept in place (``tree_flatten`` would read it as an empty subtree)."""
    if isinstance(grads, dict):
        return [leaf for k in sorted(grads) for leaf in _grad_leaves(grads[k])]
    if isinstance(grads, (list, tuple)) and not hasattr(grads, "_fields"):
        return [leaf for g in grads for leaf in _grad_leaves(g)]
    return [grads]


def masked(inner: Any, trainable: Any) -> MaskedOptimizer:
    """``MaskedOptimizer`` shorthand: ``masked(AdamW(...), ".lora_")``."""
    return MaskedOptimizer(inner=inner, trainable=trainable)
