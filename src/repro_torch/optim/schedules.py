"""Learning-rate schedules (pure functions of the step counter), computed
in fp32 like ``repro/optim/schedules.py``."""
from __future__ import annotations

import numpy as np


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def schedule(step: int) -> float:
        s = np.float32(step)
        if s < warmup_steps:
            return float(np.float32(peak_lr) * s / np.float32(max(warmup_steps, 1)))
        prog = np.clip(
            (s - np.float32(warmup_steps)) / np.float32(max(total_steps - warmup_steps, 1)),
            np.float32(0.0), np.float32(1.0),
        )
        frac = np.float32(final_frac)
        cos = np.float32(peak_lr) * (
            frac + (np.float32(1) - frac) * np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * prog))
        )
        return float(cos)

    return schedule


def constant(lr: float):
    def schedule(step: int) -> float:
        return float(np.float32(lr))

    return schedule
