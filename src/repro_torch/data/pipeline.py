"""Deterministic synthetic data sources (no dataset downloads), the port
of ``repro/data/pipeline.py``.

`SyntheticLM` generates a vocabulary-sized Markov-chain token stream so the
loss actually *decreases* during smoke training (pure-uniform tokens would
pin every model at log(V)).  Batches are produced on the host as numpy,
byte for byte the reference's for the same seed; the FL client moves them
to its device.  :func:`batch_iterator` yields them as tensors on a
device, or as DTensors on a mesh (the batch dim sharded over "data").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLM:
    """Markov-chain token stream (shared transition structure, per-silo
    starting states so silos are non-IID)."""

    vocab_size: int
    seq_len: int
    seed: int = 0
    branching: int = 4  # successors per token

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        self._succ = rng.integers(0, v, size=(v, self.branching))

    def sample(self, rng: np.random.Generator, batch: int) -> Tuple[np.ndarray, np.ndarray]:
        v = self.vocab_size
        toks = np.empty((batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=batch)
        for t in range(self.seq_len):
            pick = rng.integers(0, self.branching, size=batch)
            toks[:, t + 1] = self._succ[toks[:, t], pick]
        return toks[:, :-1], toks[:, 1:]


def _to_torch(a: np.ndarray, dtype: Any) -> torch.Tensor:
    """An ``extra`` draw in the dtype its spec names.  A numpy dtype is
    cast by numpy, as the reference casts; ``torch.bfloat16`` (numpy has
    none) goes float64 -> float32 -> bfloat16, the two roundings the
    reference's ``ml_dtypes`` cast makes."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(a).to(dtype)
    return torch.from_numpy(a.astype(dtype))


def batch_iterator(
    ds: SyntheticLM,
    batch: int,
    seed: int = 0,
    mesh: Optional[Any] = None,
    extra: Optional[Dict[str, Tuple[Tuple[int, ...], Any]]] = None,
    device: Any = "cuda",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Yields {tokens, labels[, extra...]} batches, the reference's numbers
    byte for byte for the same seed: tokens and labels, then each
    ``extra`` ``(shape, dtype)`` drawn standard normal in its order.

    Without a mesh the tensors are on ``device``.  With a ``DeviceMesh``
    they are DTensors with ``Shard(0)`` on its "data" dim and
    ``Replicate()`` on the others (the reference's ``NamedSharding(mesh,
    P("data"))``), placed from the mesh's device type."""
    from ..sharding.rules import P, placements

    rng = np.random.default_rng(seed)
    place = None
    if mesh is not None:
        from torch.distributed.tensor import distribute_tensor

        spec = placements(mesh, P("data"))
        place = lambda t: distribute_tensor(t.to(mesh.device_type), mesh, spec)  # noqa: E731
    while True:
        toks, labels = ds.sample(rng, batch)
        out: Dict[str, torch.Tensor] = {"tokens": torch.from_numpy(toks),
                                        "labels": torch.from_numpy(labels)}
        if extra:
            for name, (shape, dtype) in extra.items():
                out[name] = _to_torch(rng.standard_normal((batch,) + tuple(shape)), dtype)
        if place is not None:
            yield {k: place(v) for k, v in out.items()}
        else:
            yield {k: v.to(device) for k, v in out.items()}


@dataclasses.dataclass
class SyntheticClassification:
    """Synthetic image-classification source (FEMNIST/TIL stand-in):
    class-conditional Gaussian blobs, Dirichlet label skew per silo."""

    n_classes: int
    image_shape: Tuple[int, ...]
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._centers = rng.standard_normal((self.n_classes,) + self.image_shape) * 0.5

    def sample(
        self, rng: np.random.Generator, batch: int, class_probs: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        p = class_probs if class_probs is not None else np.full(self.n_classes, 1 / self.n_classes)
        labels = rng.choice(self.n_classes, size=batch, p=p)
        x = self._centers[labels] + rng.standard_normal((batch,) + self.image_shape) * 0.3
        return x.astype(np.float32), labels.astype(np.int32)
