from .optimizers import (
    AdamW,
    AdamWState,
    MaskedOptimizer,
    SGDMomentum,
    SGDState,
    make_optimizer,
    masked,
)
from .schedules import constant, warmup_cosine

__all__ = [
    "AdamW",
    "AdamWState",
    "MaskedOptimizer",
    "SGDMomentum",
    "SGDState",
    "constant",
    "make_optimizer",
    "masked",
    "warmup_cosine",
]
