from .federated_data import (
    ClassificationSilo,
    LMSilo,
    make_classification_silos,
    make_lm_silos,
)
from .pipeline import SyntheticClassification, SyntheticLM

__all__ = [
    "ClassificationSilo",
    "LMSilo",
    "SyntheticClassification",
    "SyntheticLM",
    "make_classification_silos",
    "make_lm_silos",
]
