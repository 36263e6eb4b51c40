"""A traced run reads the program's spans: ``harness.run`` turns them on
around its profile and joins them with the trace (``rec["phases"]``), so
the seven span metrics read where they apply; a program without the
spans module leaves them silent; ``phases.join`` gives idle seconds for
every span name."""
from __future__ import annotations

import re
import sys

import pytest

from fedbench import harness, phases
from repro_torch.utils import spans

SPAN_METRICS = set(phases.METRICS)
ON_CARD = {m for m in SPAN_METRICS if m.startswith("idle.")}


def traced_run(spec, workload, lines=None):
    log = (lambda s: lines.append(s)) if lines is not None else (lambda s: None)
    return harness.run(workload, 13, 0.05, True, "cpu", spec, log=log)


def listed(workload, kind="per_layer"):
    """The metrics of ``kind`` that BENCHMARK.json has the cell report: a
    per-layer one where the end-to-end metric it moves is reported."""
    bench = harness.benchmark()
    ends = {m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])}
    return {m["name"] for m in bench[kind] if workload in m.get("workloads", [workload])
            and m.get("moves", m["name"]) in ends | {m["name"]}}


def spans_are_off():
    with spans.span("fl.after"):
        pass
    return not spans.take().spans


@pytest.mark.parametrize("workload", ["femnist-cnn.int8-async", "femnist-cnn.dense-barrier"])
def test_a_traced_cpu_run_reads_the_spans(workload, tiny):
    """The spans are on in the traced rounds alone: the check, which
    reads set-up's rounds, gives what an untraced run of the seed gives."""
    lines = []
    result = traced_run(tiny(workload), workload, lines)
    untraced = harness.run(workload, 13, 0.05, False, "cpu", tiny(workload), log=lambda s: None)
    assert result["checks"] == untraced["checks"]
    assert not SPAN_METRICS & set(untraced["metrics"])
    got = result["metrics"]
    assert set(got) <= listed(workload) and set(untraced["metrics"]) <= listed(workload, "end_to_end")
    # round_s is end to end in the int8 cell and per layer (round_wall_s) in the dense one.
    assert ("round_s" in untraced["metrics"]) == ("round_wall_s" not in got)
    if "messages.span_s" in listed(workload):
        assert got["messages.span_s"]["value"] > 0 and got["messages.span_s"]["unit"] == "s"
        assert got["messages.serialized_gib"]["value"] > 0
    assert "alloc.growth_gib" not in got          # the counter reads a card's allocator only
    assert not ON_CARD & set(got)                 # no device time on the CPU
    assert ("fold.frame_s" in got) == (workload == "femnist-cnn.int8-async")
    if "fold.frame_s" in got:
        assert got["fold.frame_s"]["value"] > 0
    # The idle parts and the time outside them add up to the traced idle.
    (line,) = [s for s in lines if s.startswith("[fedbench] traced idle")]
    total, parts = re.match(r"\[fedbench\] traced idle (\S+) s: (.*)", line).groups()
    values = [float(p.rsplit(" ", 1)[1]) for p in parts.split(", ")]
    assert sum(values) == pytest.approx(float(total), abs=1e-5)
    assert spans_are_off()


def test_a_program_without_spans_leaves_their_metrics_silent(tiny, monkeypatch):
    import repro_torch.utils

    monkeypatch.delattr(repro_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.utils.spans", None)   # its import fails
    workload = "femnist-cnn.int8-async"
    result = traced_run(tiny(workload), workload)
    assert not SPAN_METRICS & set(result["metrics"])
    assert {"train_phase_s", "messages_s", "fold_phase_s"} <= set(result["metrics"])


def test_join_gives_idle_seconds_for_every_span_name():
    from types import SimpleNamespace

    def span(name, a, b):
        return SimpleNamespace(name=name, start_ns=a, end_ns=b)

    taken = SimpleNamespace(offset_ns=1000, counters={}, spans=[
        span("fl.round", 0, 100), span("fl.train", 10, 30), span("fl.train", 25, 50),
        span("fl.fold", 50, 60), span("fl.fold.frame", 51, 55), span("ssd.scan", 12, 22),
        span("fl.messages", 70, 90)])
    busy = [(1005, 1015), (1020, 1040), (1052, 1058), (1075, 1080), (1095, 1120)]
    ph = phases.join(busy, taken, (1000, 1100))
    idle = {k: v * 1e9 for k, v in ph["span_idle_s"].items()}
    assert set(idle) == {s.name for s in taken.spans}
    for name in ("fl.train", "fl.fold", "fl.messages"):
        assert ph["span_idle_s"][name] == ph["idle"][name]
    assert idle["fl.round"] == pytest.approx(54)        # the whole window's idle
    assert idle["fl.fold.frame"] == pytest.approx(1)    # [1051, 1055] holds 3 ns of work
    assert idle["ssd.scan"] == pytest.approx(5)         # [1012, 1022] holds 5 ns of work
    assert set(ph["idle"]) == {"fl.train", "fl.fold", "fl.messages", "outside"}
