"""Server aggregation strategies (the port of
``repro/federated/aggregation.py``).

FedAvg (McMahan et al. 2017) is the paper's method for all three
applications (§5.1): the aggregated weight is the sample-count-weighted
mean of client weights.

  `agg_engine.AggregationEngine` — what `FLServer` calls each round:
      flatten once into an (N, L) buffer, reduce it with the
      `fedavg_reduce` kernel (plain version on the CPU).
  `fedavg` (below)               — the per-leaf oracle, kept ONLY as the
      correctness ground truth for tests.

The reference's ``fedavg_stacked`` (pod replica stacks) comes with the
pod-training slice.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from ..utils.tree import tree_map


def fedavg(client_params: Sequence[Any], weights: Sequence[float]) -> Any:
    """Weighted average of client parameter trees (per-leaf oracle)."""
    w = np.asarray(weights, np.float64)
    if w.sum() <= 0:
        raise ValueError("aggregation weights must sum to a positive value")
    w = (w / w.sum()).astype(np.float32)

    def avg(*leaves: torch.Tensor) -> torch.Tensor:
        acc = leaves[0].float() * float(w[0])
        for wi, leaf in zip(w[1:], leaves[1:]):
            acc = acc + leaf.float() * float(wi)
        return acc.to(leaves[0].dtype)

    return tree_map(avg, *client_params)


def aggregate_metrics(
    client_metrics: Sequence[Dict[str, float]], weights: Sequence[float]
) -> Dict[str, float]:
    """Sample-weighted mean of scalar evaluation metrics."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    out: Dict[str, float] = {}
    for key in client_metrics[0]:
        out[key] = float(sum(wi * m[key] for wi, m in zip(w, client_metrics)))
    return out
