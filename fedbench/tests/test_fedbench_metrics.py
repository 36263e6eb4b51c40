"""Each metric's arithmetic on a synthetic record."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from fedbench import harness

ROOT = Path(__file__).resolve().parents[2]
PEAKS = json.loads((ROOT / "fedbench/peaks.json").read_text())


def record(**over):
    rounds = [{"wall_s": 4.0, "train_s": 3.0, "fold_s": 1.0, "eval_s": 0.25, "checkpoint_s": 0.0},
              {"wall_s": 6.0, "train_s": 4.0, "fold_s": 2.0, "eval_s": 0.75, "checkpoint_s": 0.25}]
    rec = {"device": "cuda", "config": {"compute_dtype": "bfloat16"}, "setup_s": 12.5,
           "window_s": 10.0, "rounds": rounds, "peak_bytes": 3 * 2 ** 30, "peaks": PEAKS,
           "flops": 989e12, "trace": {"busy_s": 0.5, "window_s": 2.0, "rounds": [{}, {}],
                                      "device_ops": {"void fedavg_vec_kernel<4>": 0.02,
                                                     "flash_fwd_wgmma": 0.1, "bwd_dq_wgmma": 0.2,
                                                     "bwd_dkdv_wgmma": 0.3, "ampere_sgemm": 1.0}},
           "work": {"fold": {"update": "dense", "silos": 4, "elems": 10 ** 9},
                    "attention": {"shape": {"B": 2, "S": 2048, "H": 16, "D": 128, "causal": True},
                                  "train_calls": 64, "eval_calls": 16}}}
    rec.update(over)
    return rec


def read(name, rec):
    return harness.load_module("metrics", name).read(rec)


def test_host_clock_metrics():
    rec = record()
    assert read("round_s", rec) == 5.0
    assert read("setup_s", rec) == 12.5
    assert read("peak_mem_gib", rec) == 3.0
    assert read("train_phase_s", rec) == pytest.approx(2.0)       # (2 + 2) / 2
    assert read("fold_phase_s", rec) == pytest.approx(1.5)
    assert read("messages_s", rec) == pytest.approx((0.75 + 1.0) / 2)
    assert read("round_mfu", rec) == pytest.approx(100 * 2 / 10)  # 2 rounds of 1 peak-second


def test_messages_is_the_rest_of_the_round():
    rec = record()
    rest = [r["wall_s"] - r["train_s"] - r["eval_s"] - r["checkpoint_s"] for r in rec["rounds"]]
    assert read("messages_s", rec) == pytest.approx(sum(rest) / 2)


def test_trace_metrics():
    rec = record()
    assert read("device_idle_share", rec) == pytest.approx(75.0)
    # fold: (4 + 1) * 1e9 * 4 bytes at 3.35 TB/s, two rounds, over 20 ms.
    assert read("fold_kernel.roofline", rec) == pytest.approx(
        100 * 2 * 20e9 / 3.35e12 / 0.02)
    B, S, H, D = 2, 2048, 16, 128
    fwd = 2.0 * B * H * D * S * (S + 1) / 989e12
    least = 64 * 3.5 * fwd + 16 * fwd
    assert read("attention.roofline", rec) == pytest.approx(100 * 2 * least / 0.6)


def test_int8_fold_counts_one_fold_a_silo():
    rec = record(work={"fold": {"update": "int8", "silos": 5, "elems": 8192 * 10}})
    rec["trace"]["device_ops"] = {"dequant_fold_vec_kernel": 1e-3}
    least = 5 * (9 * 8192 * 10 + 4 * 10) / 3.35e12
    assert read("fold_kernel.roofline", rec) == pytest.approx(100 * 2 * least / 1e-3)
    assert read("attention.roofline", rec) is None


def test_silent_without_a_trace_or_a_card():
    rec = record(trace=None)
    for name in ("device_idle_share", "fold_kernel.roofline", "attention.roofline"):
        assert read(name, rec) is None
    rec = record()
    rec["trace"]["device_ops"] = {"some_other_kernel": 1.0}
    assert read("fold_kernel.roofline", rec) is None
    assert read("round_mfu", record(device="cpu")) is None
    assert read("peak_mem_gib", record(peak_bytes=0)) is None
