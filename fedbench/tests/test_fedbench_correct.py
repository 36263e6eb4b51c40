"""The check that decides ``correct``, on the CPU at a tiny size with each
cell's own limits: a sound run passes; the control (the reference one
precision below the configuration's, put in the program's place) fails;
and a run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: a step that returns its state
unchanged, half of each batch left out, the fold's answer altered where
it is produced, and, where the update carries a codec, a silo's error
feedback dropped.  The fold stage's own control (the codec's bits
halved, or a dense fold one precision below) fails its number too.  (One
chip: no exchange between chips to leave out.)"""
from __future__ import annotations

import pytest
import torch

from fedbench import harness
from fedbench.check import fold_gap, is_correct, readings, verdict
from fedbench.reference.fedavg import fold_rounds

CELLS = ["olmo-1b.fedavg-bf16", "femnist-cnn.int8-async", "femnist-cnn.dense-barrier",
         "olmo-1b.lora8-int8"]
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def run_tiny(spec, seed=11):
    return harness.run("tiny", seed, 0.05, False, "cpu", spec, log=lambda s: None)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, tiny):
    result = run_tiny(tiny(workload, fp32=True))
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, tiny):
    spec = tiny(workload)
    dev = torch.device("cpu")
    fam = harness.load_module("families", spec["config"]["family"])
    for seed in (21, 22, 23):
        silos = fam.make_silos(spec["config"], spec["traffic"], seed, dev)
        ref = harness.reference_round(spec, silos, seed, dev)
        ctl = harness.reference_round(spec, silos, seed, dev,
                                      CONTROL[spec["config"]["compute_dtype"]])
        numbers = readings(ctl, ref, harness.evaluated(spec, ctl["params1"], silos, dev))
        assert not is_correct(verdict(numbers, spec["limits"]))


@pytest.mark.parametrize("workload", CELLS)
def test_fold_control_is_not_correct(workload, tiny):
    spec = tiny(workload)
    update = spec["traffic"]["update"]
    kw = {"precision": CONTROL[spec["config"]["compute_dtype"]]} if update == "dense" else {"bits": 4}
    for seed in (21, 22, 23):
        rounds = harness.first_round(spec, seed, torch.device("cpu"))["fold"]
        ctl = [dict(r, new=x) for r, x in zip(rounds, fold_rounds(rounds, update, **kw))]
        fold = fold_gap(ctl, fold_rounds(rounds, update))
        assert not is_correct(verdict({"fold": fold}, {"fold": spec["limits"]["fold"]}))


def _state_unchanged(monkeypatch):
    from repro_torch.optim import optimizers

    step = optimizers.AdamW.update
    monkeypatch.setattr(optimizers.AdamW, "update",
                        lambda self, g, s, p: (p, step(self, g, s, p)[1]))


def _half_batch(monkeypatch):
    from repro_torch.models import fl_models, transformer

    lm_loss, ce = transformer.lm_loss, fl_models.softmax_cross_entropy
    monkeypatch.setattr(transformer, "lm_loss",
                        lambda p, t, y, cfg, **kw: lm_loss(p, t[:1], y[:1], cfg, **kw))
    monkeypatch.setattr(fl_models, "softmax_cross_entropy",
                        lambda logits, y: ce(logits[: len(y) // 2], y[: len(y) // 2]))


def _answer_altered(monkeypatch):
    """The fold's result off by 1 %."""
    from repro_torch.federated import agg_engine
    from repro_torch.utils.tree import tree_flatten, tree_unflatten

    def altered(fn):
        def wrapped(*a, **kw):
            leaves, treedef = tree_flatten(fn(*a, **kw))
            return tree_unflatten(treedef, [t * 1.01 for t in leaves])
        return wrapped

    for cls, name in ((agg_engine.AggregationEngine, "aggregate"),
                      (agg_engine.StreamingAggregator, "result"),
                      (agg_engine.StructuredStreamingAggregator, "result")):
        monkeypatch.setattr(cls, name, altered(getattr(cls, name)))


def _feedback_dropped(monkeypatch):
    """Each silo forgets what its codec dropped the round before."""
    from repro_torch.federated import compression

    for cls in (compression.ClientCompressor, compression.StructuredCompressor):
        encode = cls.encode

        def forgetful(self, *a, _encode=encode, **kw):
            self.reset()
            return _encode(self, *a, **kw)

        monkeypatch.setattr(cls, "encode", forgetful)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, tiny, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = run_tiny(tiny(workload, fp32=True))
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", [c for c in CELLS
                                      if harness.cell_spec(c)["traffic"]["update"] != "dense"])
def test_dropped_error_feedback_is_not_correct(workload, tiny, monkeypatch):
    _feedback_dropped(monkeypatch)
    result = run_tiny(tiny(workload, fp32=True))
    assert result["checks"]["fold"]["value"] > result["checks"]["fold"]["limit"]
    assert result["correct"] is False
