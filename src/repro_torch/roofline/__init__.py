"""Three-term roofline over the H100 table, the port of
``repro.roofline``."""
from . import hardware
from .analysis import (
    CollectiveStats,
    RooflineReport,
    model_flops_estimate,
    parse_collectives,
    roofline,
)

__all__ = [
    "CollectiveStats",
    "RooflineReport",
    "hardware",
    "model_flops_estimate",
    "parse_collectives",
    "roofline",
]
