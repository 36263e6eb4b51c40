from .optimizers import AdamW, AdamWState, SGDMomentum, SGDState, make_optimizer
from .schedules import constant, warmup_cosine

__all__ = [
    "AdamW",
    "AdamWState",
    "SGDMomentum",
    "SGDState",
    "constant",
    "make_optimizer",
    "warmup_cosine",
]
