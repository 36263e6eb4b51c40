"""Spot-VM revocation model (paper §5.6).

The port's own copy of ``repro/core/revocation.py`` (numpy only): the
same process from the same seed, so a revocation schedule drawn by
either package revokes the same silos at the same times.

The paper simulates revocations "using a Poisson distribution with a
revocation rate lambda = 1/k_r", where k_r is the average time between
failures in seconds (k_r in {3600, 7200, 14400}). Matching the reported
revocation counts (e.g. 3.67 events over a ~10 h run at k_r=7200, Table 5),
this is one *global* Poisson process per execution: inter-event gaps are
Exponential(mean k_r), and each event revokes one uniformly-chosen task that
currently runs on a spot VM. Events landing when no spot VM is allocated
are absorbed. On-demand VMs never revoke.

Providers give a small grace notice before termination (AWS: 120 s,
GCP: 30 s); the recovery path assumes the checkpoint flush fits in the
grace window (client checkpoints are written every round anyway).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class RevocationModel:
    """Global Poisson revocation process."""

    k_r: Optional[float]  # mean seconds between revocation events; None = never
    seed: int = 0

    def sampler(self) -> "RevocationSampler":
        return RevocationSampler(self.k_r, np.random.default_rng(self.seed))


class RevocationSampler:
    def __init__(self, k_r: Optional[float], rng: np.random.Generator) -> None:
        self.k_r = k_r
        self.rng = rng

    def next_event_after(self, now_s: float) -> float:
        """Absolute time of the next revocation event (inf if disabled)."""
        if self.k_r is None:
            return math.inf
        return now_s + float(self.rng.exponential(self.k_r))

    def pick_victim(self, spot_tasks: Sequence[str]) -> Optional[str]:
        """Uniformly choose the task whose VM is revoked (None if no spot VM)."""
        if not spot_tasks:
            return None
        idx = int(self.rng.integers(0, len(spot_tasks)))
        return spot_tasks[idx]


GRACE_NOTICE_S = {"aws": 120.0, "gcp": 30.0}
DEFAULT_GRACE_S = 30.0
