"""Models: the paper's FL application models (``fl_models``) and the
model zoo behind one ``ModelFamily`` API (``api``; the dense, VLM and SSM
families so far).  The LoRA helpers of the reference's ``repro.models``
arrive with structured updates (``ROADMAP.md`` queue 1, item 11)."""
from .api import ModelFamily, get_model

__all__ = ["ModelFamily", "get_model"]
