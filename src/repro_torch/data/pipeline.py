"""Deterministic synthetic data sources (no dataset downloads), numpy
only — the port of the numpy half of ``repro/data/pipeline.py``.

`SyntheticLM` generates a vocabulary-sized Markov-chain token stream so the
loss actually *decreases* during smoke training (pure-uniform tokens would
pin every model at log(V)).  Batches are produced on the host as numpy,
byte for byte the reference's for the same seed; the FL client moves them
to its device.  The reference's ``batch_iterator`` (mesh placement) waits
for the sharding slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


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
