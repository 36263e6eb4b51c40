"""``fedbench/phases.py``: the program's spans joined with a trace's device
events, on synthetic lists, and the metrics that read the join."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from fedbench import harness, phases
from repro_torch.utils import spans

OFFSET = 1000


def _span(name, a, b, **attrs):
    return SimpleNamespace(name=name, start_ns=a, end_ns=b, attrs=attrs)


def _taken(counters=None):
    """A round on the spans' clock: two silos' training overlapping (as
    threads would), a fold with a frame nested in it, messages."""
    return SimpleNamespace(offset_ns=OFFSET, counters=counters or {}, spans=[
        _span("fl.round", 0, 100), _span("fl.train", 10, 30, silo="a"),
        _span("fl.train", 25, 50, silo="b"), _span("fl.fold", 50, 60),
        _span("fl.fold.frame", 51, 55), _span("fl.messages", 70, 90)])


# Device work on the profiler's clock; the last interval runs past the window.
BUSY = [(1005, 1015), (1020, 1040), (1052, 1058), (1075, 1080), (1095, 1120)]
WINDOW = (1000, 1100)


def test_idle_is_put_down_to_the_phases_on_the_profiler_clock():
    ph = phases.join(BUSY, _taken(), WINDOW)
    ns = pytest.approx
    assert ph["rounds"] == 1
    assert ph["window_s"] == ns(100e-9) and ph["busy_s"] == ns(46e-9)
    assert ph["idle_s"] == ns(54e-9)
    # fl.train's union [1010, 1050] holds 25 ns of device work.
    assert ph["idle"] == {"fl.train": ns(15e-9), "fl.fold": ns(4e-9),
                          "fl.messages": ns(15e-9), "outside": ns(20e-9)}
    assert sum(ph["idle"].values()) == ns(ph["idle_s"])
    assert ph["span_s"]["fl.train"] == ns(45e-9)          # each span, not their union
    assert ph["span_s"]["fl.fold.frame"] == ns(4e-9)
    assert ph["lag_s"] == {"fl.train": [ns(15e-9), ns(10e-9)], "fl.fold": [ns(2e-9)]}


def test_the_offset_moves_the_spans():
    taken = _taken()
    taken.offset_ns = OFFSET + 5
    ph = phases.join(BUSY, taken, WINDOW)
    assert ph["idle"]["fl.fold"] == pytest.approx(7e-9)   # [1055, 1065] holds 3 ns of work
    assert sum(ph["idle"].values()) == pytest.approx(ph["idle_s"])


def test_a_fold_without_device_work_has_no_lag():
    assert phases.join([], _taken(), WINDOW)["lag_s"]["fl.fold"] == [None]


def test_user_annotations_are_not_device_time():
    events = [(0, 10, False), (5, 50, True), (20, 30, False), (25, 40, False)]
    assert phases.device_busy(events) == [(0, 10), (20, 40)]


def _rec(**phases_over):
    ph = {"rounds": 2, "span_s": {"fl.messages": 3.0, "fl.fold.frame": 1.5},
          "idle": {"fl.train": 0.25, "fl.fold": 0.75, "fl.messages": 2.0, "outside": 0.1},
          "counters": {"fl.bytes.serialized": 2 ** 31, "fl.alloc.reserved": 2 ** 29}}
    ph.update(phases_over)
    return {"device": "cuda", "trace": {}, "phases": ph}


READINGS = {"messages.span_s": 1.5, "messages.serialized_gib": 1.0, "fold.frame_s": 0.75, "idle.train_s": 0.125, "idle.fold_s": 0.375,
            "idle.messages_s": 1.0, "alloc.growth_gib": 0.25}


def _read(name, rec):
    return harness.load_module("metrics", name).read(rec)


@pytest.mark.parametrize("name", phases.METRICS)
def test_each_metric_reads_its_phase_a_round(name):
    assert _read(name, _rec()) == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", phases.METRICS)
def test_each_metric_is_silent_without_its_input(name):
    assert _read(name, {"device": "cuda", "trace": None}) is None    # a run with no join
    assert _read(name, _rec(rounds=0)) is None
    assert _read(name, _rec(span_s={}, idle={}, counters={})) is None
    if name.startswith("idle."):
        assert _read(name, dict(_rec(), device="cpu")) is None


def test_a_traced_block_with_spans_on_the_cpu(tiny):
    """A tiny cell's traced round with the program's spans on: every span
    lies on the window's clock, the idle parts sum to the window's idle
    time, and no ``fl.*`` name reaches the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from fedbench.trace import summarize

    spec = tiny("femnist-cnn.int8-async")
    dev = torch.device("cpu")
    first = harness.first_round(spec, 11, dev)
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter_ns()
        tt = time.monotonic()
        harness.one_round(first["server"], first["next_round"], dev)
        traced_s = time.monotonic() - tt
        t1 = time.perf_counter_ns()
    block = dict(summarize(prof), window_s=traced_s)
    taken = spans.take()
    spans.disable()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not [n for n in names if n.startswith("fl.")]
    assert not [n for n in block["device_ops"] if n.startswith("fl.")]
    window = (t0 + taken.offset_ns, t1 + taken.offset_ns)
    ph = phases.join(phases.device_busy(phases.device_events(prof)), taken, window)
    assert ph["rounds"] == 1 and ph["busy_s"] == 0.0
    assert set(ph["idle"]) == set(phases.PHASES) | {"outside"}
    assert sum(ph["idle"].values()) == pytest.approx(ph["idle_s"], rel=1e-9)
    assert ph["idle"]["outside"] < 0.05 * ph["idle_s"]
    assert ph["span_s"]["fl.fold.frame"] > 0 and ph["counters"]["fl.bytes.serialized"] > 0
    assert ph["window_s"] == pytest.approx(block["window_s"], abs=1e-3)
    rec = {"device": "cpu", "phases": ph}
    assert _read("fold.frame_s", rec) > 0 and _read("idle.fold_s", rec) is None
