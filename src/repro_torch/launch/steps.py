"""Step functions for the model zoo, the port of ``repro/launch/steps.py``:

  prefill_step — full-prompt forward (inference);
  serve_step   — ONE new token against the KV / state cache.

Both run without autograd (``torch.no_grad``): neither kernel has
a backward.  ``make_train_step`` comes with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.api import ModelFamily


def make_prefill_step(model: ModelFamily):
    def prefill_step(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch)

    return prefill_step


def make_serve_step(model: ModelFamily, sliding_window: Optional[int] = None):
    def serve_step(params, cache, token, pos):
        """(logits (B, 1, V), cache); ``cache`` is updated in place."""
        with torch.no_grad():
            return model.decode_step(params, token, cache, pos, sliding_window=sliding_window)

    return serve_step
