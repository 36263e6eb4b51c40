"""Shared helpers of the benchmark's CPU tests (run them with
``python -m pytest -q fedbench/tests`` from the repository's root)."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_spec(workload: str, fp32: bool = False) -> dict:
    """The cell's files, at a size the CPU runs in a second: the family's
    shapes kept, its widths and silos cut.  ``fp32`` runs a bfloat16
    configuration in float32: at these widths bfloat16's rounding averages
    out over too few elements to stay under limits set at full width."""
    from fedbench import harness

    spec = copy.deepcopy(harness.cell_spec(workload))
    cfg, traffic = spec["config"], spec["traffic"]
    if cfg["family"] == "olmo":
        cfg.update(n_layers=2, d_model=64, n_heads=2, head_dim=32, d_ff=128, vocab_size=97)
        traffic.update(silos=[[8, 2], [8, 2]], context=16)
        if fp32:
            cfg.update(param_dtype="float32", compute_dtype="float32")
    else:
        cfg.update(n_fc=2, fc_width=64)
        traffic.update(silos=[[140, 10], [150, 12]])
    return spec


@pytest.fixture
def tiny():
    return tiny_spec
