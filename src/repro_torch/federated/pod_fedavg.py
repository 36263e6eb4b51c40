"""Cross-silo FedAvg over pod replicas, the port of
``repro/federated/pod_fedavg.py``.

Each FL silo maps to one pod replica.  Parameters and optimizer state
carry a leading ``n_pods`` axis, so every pod holds an independent
replica; each takes ``local_steps`` optimizer steps on its own batches.
Once a round, FedAvg averages the replicas over the pod axis and every
pod continues from the average: ``aggregation.fedavg_stacked``, which
flattens the whole replica stack into one ``(n_pods, L)`` buffer and
reduces it with one ``fedavg_reduce`` launch.  The paper's communication
pattern: rounds as synchronization barriers.

The reference ``jax.vmap``s the pods' local steps.  The port loops over
them:
- ``torch.func.vmap`` cannot batch through the kernels, which are
  launched through ctypes, and neither the flash nor the SSD autograd
  Function has a vmap rule;
- stacking the replicas on the kernels' batch axis is not possible: every
  pod has its own weights, so every projection differs;
- on one card a vmap would take the same serial device time.
Pod ``p`` trains on the views ``x[p]`` of the stacked trees, and its new
parameters and moments go into preallocated output stacks as soon as its
last local step ends, so one pod's step temporaries are alive at a time.
The step is pure: its inputs are left untouched.

The optimizer's ``step`` is one Python ``int`` for all pods (the
reference's is an ``(n_pods,)`` array whose entries are always equal).
``make_train_step``, the plain single-silo step the pods take, is
``launch/steps.py``'s, re-exported here as the reference exports its own.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..launch.steps import make_train_step
from ..utils.tree import tree_leaves, tree_map
from .aggregation import fedavg_stacked


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map(fn, tree: Any) -> Any:
    """``fn`` over every tensor of a parameter tree or an optimizer state
    (a ``NamedTuple`` of trees and an ``int`` step, which is kept)."""
    if _is_namedtuple(tree):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (dict, list, tuple, torch.Tensor)):
        return tree_map(fn, tree)
    return tree


def _tensors(tree: Any) -> list:
    if _is_namedtuple(tree):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, (dict, list, tuple, torch.Tensor)):
        return tree_leaves(tree)
    return []


def _with_scalars(stacks: Any, last: Any) -> Any:
    """``stacks`` with its non-tensor fields (the ``step``) taken from
    ``last``."""
    if _is_namedtuple(stacks):
        return type(stacks)(*(_with_scalars(s, x) for s, x in zip(stacks, last)))
    if isinstance(stacks, (dict, list, tuple, torch.Tensor)):
        return stacks
    return last


def init_pod_state(model: Any, optimizer: Any, gen: torch.Generator, n_pods: int,
                   device: Any = "cuda") -> Tuple[Any, Any]:
    """Per-pod replicated init: ``n_pods`` copies of one init on a leading
    axis (the FL server broadcasts the initial model), each a real copy.
    The optimizer's init is per element (zero moments), so it is taken on
    the stack directly, which equals stacking one init without holding
    both."""
    params = model.init(gen, device)
    stacked = tree_map(lambda x: x.unsqueeze(0).expand((n_pods,) + x.shape).contiguous(), params)
    del params
    return stacked, optimizer.init(stacked)


def make_fl_round_step(
    model: Any,
    optimizer: Any,
    local_steps: int,
    pod_weights: Optional[Any] = None,
    unroll: bool = False,
):
    """Build the FL round step.

    Args to the returned fn:
      stacked_params / stacked_opt : trees with leading n_pods axis
      batches : {name: (n_pods, local_steps, per_pod_batch, ...)}

    Returns (new_params, new_opt, mean_loss).  After the round every pod
    holds the same aggregated weights, ``n_pods`` materialised copies in
    the parameters' dtype; per-silo optimizer moments stay silo-local, as
    in the paper (only weights flow through the server).  A pod's loss is
    the mean of its step losses, the round's the mean over pods.
    ``unroll`` is the reference's ``lax.scan`` option; a Python loop has
    nothing to unroll."""
    del unroll
    train_step = make_train_step(model, optimizer)

    def fl_round_step(stacked_params, stacked_opt, batches: Dict[str, torch.Tensor]):
        n_pods = tree_leaves(stacked_params)[0].shape[0]
        new_params = tree_map(torch.empty_like, stacked_params)
        new_opt = _map(torch.empty_like, stacked_opt)
        losses = []
        for pod in range(n_pods):
            params = tree_map(lambda x: x[pod], stacked_params)
            opt_state = _map(lambda x: x[pod], stacked_opt)
            pod_losses = []
            for s in range(local_steps):
                batch = {k: v[pod, s] for k, v in batches.items()}
                params, opt_state, loss = train_step(params, opt_state, batch)
                pod_losses.append(loss)
            for dst, src in zip(tree_leaves(new_params), tree_leaves(params)):
                dst[pod].copy_(src)
            for dst, src in zip(_tensors(new_opt), _tensors(opt_state)):
                dst[pod].copy_(src)
            losses.append(torch.stack(pod_losses).mean())
            new_opt = _with_scalars(new_opt, opt_state)
            del params, opt_state, pod_losses
        w = pod_weights if pod_weights is not None else torch.ones(n_pods)
        # FedAvg barrier: weighted mean over the pod axis, broadcast back.
        avg = fedavg_stacked(new_params, w)
        for dst, a in zip(tree_leaves(new_params), tree_leaves(avg)):
            dst.copy_(a.unsqueeze(0).expand_as(dst))
        return new_params, new_opt, torch.stack(losses).mean()

    return fl_round_step


def pod_batch_shape(
    cfg: ModelConfig, n_pods: int, local_steps: int, global_batch: int, seq_len: int
) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Shapes for the fl_round_step batch tree (global batch split over
    pods)."""
    per_pod = global_batch // n_pods
    base = (n_pods, local_steps, per_pod)
    shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {
        "tokens": (base + (seq_len,), torch.int32),
        "labels": (base + (seq_len,), torch.int32),
    }
    if cfg.arch_type == "vlm":
        shapes["patch_embeds"] = (base + (cfg.n_image_tokens, cfg.d_model), cfg.activation_dtype)
    if cfg.arch_type == "encdec":
        shapes["frames"] = (base + (cfg.encoder_seq, cfg.d_model), cfg.activation_dtype)
    return shapes
