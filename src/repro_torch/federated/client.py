"""FL client: local training over a private silo (paper §3).

The port of ``repro/federated/client.py``.  Each client receives the
global weights, runs ``local_epochs`` of value-and-grad plus an optimizer
step over its silo, and returns (updated weights, n_samples, wall time).
The evaluation phase runs the silo's test split and returns scalar
metrics.

Gradients come from ``torch.autograd.grad`` on detached copies of the
leaves, and the optimizer updates out of place, so the global tree the
server hands every client is never written to.  Under a
:class:`~repro_torch.optim.MaskedOptimizer` (federated LoRA) only the
leaves it trains take a gradient: the reference differentiates every
leaf and the mask then drops the frozen leaves' update, so the result is
the same, but at olmo-1b's width that is a weight-gradient product for
1.18 B frozen parameters every step.  Batches come off the
silo as numpy and go to the client's ``device`` (the default
``batch_fn``).  With ``compression=`` the client owns a
:class:`~repro_torch.federated.compression.ClientCompressor`, so its
error-feedback residual stays with the silo across rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from ..optim.optimizers import MaskedOptimizer
from ..utils import spans
from ..utils.tree import tree_flatten, tree_unflatten

Device = Union[str, torch.device]


@dataclasses.dataclass
class ClientResult:
    client_id: str
    params: Any
    n_samples: int
    train_time_s: float


@dataclasses.dataclass
class EvalResult:
    client_id: str
    metrics: Dict[str, float]
    n_samples: int
    eval_time_s: float


def to_device(raw: Any, device: Device) -> Any:
    """A numpy batch (array, tuple or dict of arrays) as tensors on ``device``."""
    if isinstance(raw, tuple):
        return tuple(torch.as_tensor(r, device=device) for r in raw)
    if isinstance(raw, dict):
        return {k: torch.as_tensor(v, device=device) for k, v in raw.items()}
    return torch.as_tensor(raw, device=device)


def synchronize(device: Device) -> None:
    """Wait for ``device``'s queued work (the counterpart of
    ``jax.block_until_ready``); a no-op on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tree_device(tree: Any) -> torch.device:
    """The device of a tree's first tensor leaf (CPU if it has none)."""
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


class FLClient:
    """One cross-silo FL client.

    loss_fn(params, batch) -> scalar tensor; batch is whatever the silo
    yields, converted by ``batch_fn`` (default: numpy arrays to tensors on
    ``device``).  eval_fn(params, batch) -> dict of per-batch values
    reduced over batches: keys with a ``_sum`` suffix are example-weighted
    sums that `evaluate` averages (dividing by the split size, suffix
    stripped); any other key is reported as its plain total.
    """

    def __init__(
        self,
        client_id: str,
        silo: Any,
        loss_fn: Callable[[Any, Any], torch.Tensor],
        optimizer: Any,
        batch_size: int = 32,
        local_epochs: int = 1,
        batch_fn: Optional[Callable] = None,
        eval_fn: Optional[Callable[[Any, Any], Dict[str, torch.Tensor]]] = None,
        device: Device = "cuda",
        compression: Any = None,
    ) -> None:
        self.client_id = client_id
        self.silo = silo
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.batch_size = batch_size
        self.local_epochs = local_epochs
        self.device = torch.device(device)
        self.batch_fn = batch_fn or (lambda b: to_device(b, self.device))
        self.eval_fn = eval_fn
        # Client-owned compression state: the error-feedback residual
        # stays with the silo, and AsyncFLServer prefers this compressor
        # when the wire path is compressed.
        self.compressor = None
        if compression is not None:
            from .compression import ClientCompressor, parse_compression

            spec = parse_compression(compression)
            if spec is not None:
                self.compressor = ClientCompressor(spec)

    def _train_step(self, params: Any, opt_state: Any, batch: Any):
        leaves, treedef = tree_flatten(params)
        if isinstance(self.optimizer, MaskedOptimizer):
            trains = tree_flatten(self.optimizer.trainable_mask(params))[0]
        else:
            trains = [True] * len(leaves)
        live = [leaf.detach().requires_grad_(t) for leaf, t in zip(leaves, trains)]
        loss = self.loss_fn(tree_unflatten(treedef, live), batch)
        got = iter(torch.autograd.grad(loss, [x for x, t in zip(live, trains) if t]))
        grads = [next(got) if t else None for t in trains]
        params, opt_state = self.optimizer.update(
            tree_unflatten(treedef, grads), opt_state, params
        )
        return params, opt_state, loss.detach()

    # -- training phase ------------------------------------------------------
    def train(self, global_params: Any) -> ClientResult:
        with spans.timer("fl.train", silo=self.client_id) as timed:
            params = global_params
            # Fresh optimizer state per round (clients are stateless across
            # rounds w.r.t. the optimizer; only weights flow through the server).
            opt_state = self.optimizer.init(params)
            # n_samples is the silo's per-epoch example count — the FedAvg
            # weight (§3).  Count one epoch's pass exactly rather than
            # dividing the multi-epoch total (ragged last batches).
            n_first_epoch = 0
            for epoch in range(self.local_epochs):
                for raw in self.silo.batches(self.batch_size, split="train"):
                    batch = self.batch_fn(raw)
                    params, opt_state, _ = self._train_step(params, opt_state, batch)
                    if epoch == 0:
                        n_first_epoch += _batch_count(raw)
            synchronize(self.device)
        return ClientResult(
            client_id=self.client_id,
            params=params,
            n_samples=n_first_epoch,
            train_time_s=timed.seconds,
        )

    def encode_update(self, global_params: Any, local_params: Any) -> Any:
        """Compress this round's update with the client-owned
        error-feedback buffer (requires ``compression=`` at init)."""
        if self.compressor is None:
            raise ValueError(
                f"client {self.client_id!r} has no compressor; pass "
                "compression= when constructing the FLClient"
            )
        return self.compressor.encode(global_params, local_params)

    # -- evaluation phase -----------------------------------------------------
    @torch.no_grad()
    def evaluate(self, aggregated_params: Any) -> EvalResult:
        with spans.timer("fl.eval", silo=self.client_id) as timed:
            sums: Dict[str, float] = {}
            n = 0
            for raw in self.silo.batches(self.batch_size, split="test"):
                batch = self.batch_fn(raw)
                if self.eval_fn is not None:
                    out = self.eval_fn(aggregated_params, batch)
                else:
                    out = {"loss_sum": self.loss_fn(aggregated_params, batch) * _batch_count(raw)}
                for k, v in out.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
                n += _batch_count(raw)
            # Average only the keys that declare themselves example-weighted
            # sums via a "_sum" suffix, stripping exactly that suffix.
            metrics = {
                (k[: -len("_sum")] if k.endswith("_sum") else k):
                    (v / max(n, 1) if k.endswith("_sum") else v)
                for k, v in sums.items()
            }
        return EvalResult(
            client_id=self.client_id,
            metrics=metrics,
            n_samples=n,
            eval_time_s=timed.seconds,
        )


def _batch_count(raw) -> int:
    if isinstance(raw, tuple):
        return int(np.shape(raw[0])[0])
    if isinstance(raw, dict):
        return int(np.shape(next(iter(raw.values())))[0])
    return int(np.shape(raw)[0])
