"""Federated silo partitioning (Cross-Silo, non-IID).

Each client (silo) owns a private shard: classification silos get
Dirichlet(alpha) label skew (the standard LEAF-style non-IID recipe);
LM silos get distinct Markov starting distributions. Silos never exchange
raw data — only model weights flow, per the FL contract (§1).

The port of ``repro/data/federated_data.py``: numpy only, and the same
seeds give byte-identical batches.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

from .pipeline import SyntheticClassification, SyntheticLM


@dataclasses.dataclass
class ClassificationSilo:
    client_id: str
    class_probs: np.ndarray
    n_train: int
    n_test: int
    source: SyntheticClassification
    seed: int

    def batches(self, batch: int, split: str = "train") -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = self.n_train if split == "train" else self.n_test
        rng = np.random.default_rng(self.seed + (0 if split == "train" else 10_000))
        remaining = n
        while remaining > 0:
            b = min(batch, remaining)
            yield self.source.sample(rng, b, self.class_probs)
            remaining -= b


def make_classification_silos(
    n_clients: int,
    n_classes: int,
    image_shape: Tuple[int, ...],
    samples_per_client: List[Tuple[int, int]],
    alpha: float = 0.5,
    seed: int = 0,
) -> List[ClassificationSilo]:
    """Dirichlet(alpha) label-skewed silos over a shared class structure."""
    if len(samples_per_client) != n_clients:
        raise ValueError(
            f"{len(samples_per_client)} sample counts for {n_clients} clients"
        )
    rng = np.random.default_rng(seed)
    source = SyntheticClassification(n_classes, image_shape, seed=seed)
    silos = []
    for i, (n_tr, n_te) in enumerate(samples_per_client):
        probs = rng.dirichlet(np.full(n_classes, alpha))
        silos.append(
            ClassificationSilo(
                client_id=f"client_{i}",
                class_probs=probs,
                n_train=n_tr,
                n_test=n_te,
                source=source,
                seed=seed + 100 + i,
            )
        )
    return silos


@dataclasses.dataclass
class LMSilo:
    client_id: str
    dataset: SyntheticLM
    n_train: int
    n_test: int
    seed: int

    def batches(self, batch: int, split: str = "train") -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = self.n_train if split == "train" else self.n_test
        rng = np.random.default_rng(self.seed + (0 if split == "train" else 10_000))
        remaining = n
        while remaining > 0:
            b = min(batch, remaining)
            yield self.dataset.sample(rng, b)
            remaining -= b


def make_lm_silos(
    n_clients: int,
    vocab_size: int,
    seq_len: int,
    samples_per_client: List[Tuple[int, int]],
    seed: int = 0,
) -> List[LMSilo]:
    """Shared transition structure, per-silo seeds (distinct token mixes) —
    the Shakespeare "each character is a silo" analogue."""
    silos = []
    for i, (n_tr, n_te) in enumerate(samples_per_client):
        ds = SyntheticLM(vocab_size, seq_len, seed=seed)  # shared "language"
        silos.append(
            LMSilo(
                client_id=f"client_{i}",
                dataset=ds,
                n_train=n_tr,
                n_test=n_te,
                seed=seed + 1000 * (i + 1),  # distinct sampling -> non-IID mixes
            )
        )
    return silos
