"""Step functions for the model zoo, the port of ``repro/launch/steps.py``:

  train_step   — loss + gradients + optimizer update, with optional
                 gradient accumulation over ``microbatches`` splits of
                 the batch;
  prefill_step — full-prompt forward (inference);
  serve_step   — ONE new token against the KV / state cache.

Training differentiates ``ModelFamily.loss`` with autograd.  On a card
the attention's gradient is the hand-written backward kernel in
``kernels/flash_attention.py`` and the SSD scan's the one in
``kernels/ssd_scan.py``, so every ported family trains there.  Prefill
and serving run without autograd (``torch.no_grad``), and the flash
forward kernel then stores no log-sum-exp.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..configs.base import ModelConfig
from ..models.api import ModelFamily
from ..optim import make_optimizer
from ..sharding.context import compute_mesh
from ..utils.tree import tree_flatten, tree_map, tree_unflatten


def with_compute_mesh(fn, mesh):
    """``fn`` run under the compute-mesh context, so model code reads the
    mesh (``models/moe.py``'s group count, ``scan_layers``)."""

    def wrapped(*args):
        with compute_mesh(mesh):
            return fn(*args)

    return wrapped


def make_optimizer_for(cfg: ModelConfig):
    return make_optimizer("adamw", 3e-4, state_dtype=cfg.optimizer_state_dtype)


def make_train_step(model: ModelFamily, optimizer: Any, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``.

    With ``microbatches > 1`` the batch's leading axis is split into that
    many equal parts; their gradients are summed in the parameters' dtype
    and divided by ``microbatches``, and the loss is their fp32 mean, as
    the reference's ``lax.scan`` accumulates them."""

    def grads_of(params, batch):
        leaves, treedef = tree_flatten(params)
        live = [leaf.detach().requires_grad_(True) for leaf in leaves]
        loss = model.loss(tree_unflatten(treedef, live), batch)
        return loss.detach(), list(torch.autograd.grad(loss, live))

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = grads_of(params, batch)
        else:
            def split(x):
                if x.shape[0] % microbatches:
                    raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                                     f"{microbatches} microbatches")
                return x.reshape((microbatches, x.shape[0] // microbatches) + x.shape[1:])

            micro = tree_map(split, batch)
            leaves = tree_flatten(params)[0]
            grads = [torch.zeros_like(p) for p in leaves]
            loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for i in range(microbatches):
                loss, g = grads_of(params, tree_map(lambda x: x[i], micro))
                grads = [a + b.to(a.dtype) for a, b in zip(grads, g)]
                loss_sum = loss_sum + loss
            loss = loss_sum / microbatches
            grads = [g / microbatches for g in grads]
        params, opt_state = optimizer.update(
            tree_unflatten(tree_flatten(params)[1], grads), opt_state, params)
        return params, opt_state, loss

    return train_step


def make_prefill_step(model: ModelFamily):
    def prefill_step(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch)

    return prefill_step


def make_serve_step(model: ModelFamily, sliding_window: Optional[int] = None):
    def serve_step(params, cache, token, pos):
        """(logits (B, 1, V), cache); ``cache`` is updated in place."""
        with torch.no_grad():
            return model.decode_step(params, token, cache, pos, sliding_window=sliding_window)

    return serve_step
