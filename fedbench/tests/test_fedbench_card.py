"""A cell run for a few seconds on the card (``-m gpu``; skipped without
one, decided inside the test)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, "fedbench/run.py", "--workload",
                          "femnist-cnn.dense-barrier", "--seed", "4294967311", "--seconds", "3",
                          "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert {"train_phase_s", "device_idle_share", "fold_kernel.roofline"} <= set(result["metrics"])
