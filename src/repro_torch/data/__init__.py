from .federated_data import (
    ClassificationSilo,
    LMSilo,
    make_classification_silos,
    make_lm_silos,
)
from .pipeline import SyntheticClassification, SyntheticLM, batch_iterator

__all__ = [
    "ClassificationSilo",
    "LMSilo",
    "SyntheticClassification",
    "SyntheticLM",
    "batch_iterator",
    "make_classification_silos",
    "make_lm_silos",
]
