"""The port's spans and counters (``repro_torch.utils.spans``) over real
rounds of a tiny FEMNIST model on the CPU: off they record nothing and
the round record keeps its timers; on, the spans nest as the round runs,
each timed field of the round record is its span's ``seconds``, and the
byte counters count the frames the round builds."""
import threading
import time

import pytest
import torch

from repro_torch.checkpoint import ClientCheckpointManager
from repro_torch.checkpoint.serializer import serialize_pytree
from repro_torch.core.events import CheckpointSaved
from repro_torch.data import make_classification_silos
from repro_torch.federated import AsyncFLServer, FLClient, FLServer
from repro_torch.federated.compression import (
    StructuredUpdate,
    compressed_wire_bytes,
    parse_compression,
    serialize_structured,
    serialize_update,
)
from repro_torch.federated.messages import serialize_metrics
from repro_torch.models import fl_models as fm
from repro_torch.optim import make_optimizer
from repro_torch.utils import spans
from repro_torch.utils.tree import tree_leaves

CFG = fm.FemnistConfig(n_fc=1, fc_width=16)
SAMPLES = [(24, 8), (16, 8)]
KINDS = ["barrier", "int8", "structured-int8"]

# Each span's parent, by name, in a round of the barrier or async server.
PARENT = {
    "fl.round": None,
    "fl.training": "fl.round",
    "fl.train": "fl.training",
    "fl.fold": "fl.training",
    "fl.fold.add": "fl.fold",
    "fl.fold.frame": "fl.fold.add",
    "fl.fold.finalize": "fl.fold",
    "fl.evaluation": "fl.round",
    "fl.eval": "fl.evaluation",
    "fl.checkpoint": "fl.round",
    "fl.messages": "fl.round",
    "optim.update": "fl.train",
}


@pytest.fixture(autouse=True)
def spans_off():
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


def _server(kind, tmp_path=None):
    def loss_fn(p, b):
        return fm.softmax_cross_entropy(fm.femnist_forward(p, b[0], CFG), b[1])

    def eval_fn(p, b):
        return {"loss_sum": loss_fn(p, b) * b[0].shape[0]}

    silos = make_classification_silos(len(SAMPLES), 62, (28, 28, 1), SAMPLES, seed=0)
    clients = [FLClient(s.client_id, s, loss_fn, make_optimizer("adamw", 1e-3), batch_size=8,
                        eval_fn=eval_fn, device="cpu") for s in silos]
    params = fm.init_femnist_cnn(torch.Generator().manual_seed(0), CFG, device="cpu")
    kw = dict(measure_round_messages=True, device="cpu")
    if tmp_path is not None:
        kw["client_ckpts"] = {c.client_id: ClientCheckpointManager(str(tmp_path / c.client_id))
                              for c in clients}
    if kind == "barrier":
        return FLServer(clients, params, **kw)
    schema = {"head": "head"} if kind == "structured-int8" else None
    return AsyncFLServer(clients, params, compression="int8", schema=schema, **kw)


def _recording_folds(server):
    """Wraps the server's fold engine to keep each round's updates."""
    updates = []
    inner = server._round_engine.fold_round

    def recorded(round_idx, results, *args, **kw):
        updates.append([r.params for r in results])
        return inner(round_idx, results, *args, **kw)

    server._round_engine.fold_round = recorded
    return updates


def _by_name(taken, name):
    return [s for s in taken.spans if s.name == name]


def test_off_records_nothing_and_keeps_the_record():
    assert spans.span("fl.round", round=1) is spans.span("fl.fold")
    assert isinstance(spans.timer("fl.fold"), spans.Timer)
    off = _server("int8")
    rec_off = off.run(2).rounds
    taken = spans.take()
    assert taken.spans == [] and taken.counters == {}

    spans.enable()
    on = _server("int8")
    rec_on = on.run(2).rounds
    spans.disable()
    for a, b in zip(rec_off, rec_on):
        assert a.round_idx == b.round_idx and a.metrics == b.metrics
        assert a.message_log == b.message_log
        assert sorted(a.fold_times_s) == sorted(b.fold_times_s)
        assert a.train_time_s >= a.agg_time_s > 0 and a.eval_time_s > 0
        assert a.checkpoint_time_s >= 0
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(off.params), tree_leaves(on.params)))


@pytest.mark.parametrize("kind", KINDS)
def test_span_tree_nests_as_the_round_runs(kind):
    server = _server(kind)
    spans.enable()
    server.run(2)
    taken = spans.take()
    spans.disable()
    n = len(SAMPLES)
    names = [s.name for s in taken.spans]
    steps = sum(len(list(c.silo.batches(8, split="train"))) for c in server.clients)
    per_round = {"fl.round": 1, "fl.training": 1, "fl.train": n, "fl.fold": 1,
                 "fl.evaluation": 1, "fl.eval": n, "fl.checkpoint": 2, "fl.messages": 1,
                 "optim.update": steps}
    if kind != "barrier":
        per_round.update({"fl.fold.add": n, "fl.fold.frame": n, "fl.fold.finalize": 1})
    assert {k: names.count(k) for k in set(names)} == {k: 2 * v for k, v in per_round.items()}
    for s in taken.spans:
        parent = taken.spans[s.parent] if s.parent is not None else None
        assert (parent.name if parent else None) == PARENT[s.name], s
        if parent is not None:
            assert parent.index < s.index and s.round == parent.round
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert [s.round for s in _by_name(taken, "fl.round")] == [1, 2]
    silos = [c.client_id for c in server.clients] * 2
    for name in ("fl.train", "fl.eval") + (("fl.fold.add",) if kind != "barrier" else ()):
        assert [s.attrs["silo"] for s in _by_name(taken, name)] == silos
    assert [s.attrs["where"] for s in _by_name(taken, "fl.checkpoint")] == \
        ["client_local", "server_remote"] * 2


@pytest.mark.parametrize("kind", ["barrier", "int8"])
def test_record_fields_are_their_spans_seconds(kind, tmp_path):
    server = _server(kind, tmp_path)
    saved = []
    server.bus.subscribe(CheckpointSaved, saved.append)
    spans.enable()
    records = server.run(2).rounds
    client = server.clients[0]
    trained = client.train(server.params)
    evaluated = client.evaluate(server.params)
    taken = spans.take()
    spans.disable()
    for rec in records:
        def one(name, rec=rec):
            (s,) = [s for s in _by_name(taken, name) if s.round == rec.round_idx]
            return s.seconds

        ckpt = [s for s in _by_name(taken, "fl.checkpoint") if s.round == rec.round_idx]
        assert rec.train_time_s == one("fl.training")
        assert rec.agg_time_s == one("fl.fold")
        assert rec.eval_time_s == one("fl.evaluation")
        assert rec.checkpoint_time_s == ckpt[0].seconds + ckpt[1].seconds
        assert [e.overhead_s for e in saved if e.round_idx == rec.round_idx] == [ckpt[0].seconds]
    assert trained.train_time_s == _by_name(taken, "fl.train")[-1].seconds
    assert evaluated.eval_time_s == _by_name(taken, "fl.eval")[-1].seconds
    if kind == "int8":
        adds = [s.seconds for s in _by_name(taken, "fl.fold.add")]
        folds = [e.fold_end_s - e.fold_start_s for r in server.fold_reports for e in r.events]
        assert folds == pytest.approx(adds, rel=1e-9)


@pytest.mark.parametrize("kind", KINDS)
def test_byte_counters_count_the_frames_built(kind):
    server = _server(kind)
    updates = _recording_folds(server) if kind != "barrier" else None
    spans.enable()
    rec = server.run(1).rounds[0]
    taken = spans.take()
    spans.disable()
    serialized = len(serialize_pytree(server.params)) + len(serialize_metrics(rec.metrics))
    if kind == "int8":
        total = sum(t.numel() for t in tree_leaves(server.params))
        serialized += compressed_wire_bytes(total, parse_compression("int8"))
    elif kind == "structured-int8":
        serialized += rec.message_log.c_msg_train_bytes + sum(
            rec.message_log.group_wire_bytes.values())
    assert taken.counters["fl.bytes.serialized"] == {1: serialized}
    # A CPU tree's blob takes none of its bytes through the pinned buffer.
    assert sum(taken.counters.get("fl.bytes.staged", {}).values()) == 0
    if kind != "barrier":
        # The frames the fold builds on the host (one ``fl.fold.frame`` span
        # each) are counted by the engine's own stats, not by a counter.
        ser = serialize_structured if kind == "structured-int8" else serialize_update
        assert all(isinstance(u, StructuredUpdate) == (kind == "structured-int8")
                   for u in updates[0])
        stats = server._round_engine.agg_engine.stats
        assert stats.total_wire_bytes == sum(len(ser(u)) for u in updates[0])
        assert len(_by_name(taken, "fl.fold.frame")) == len(updates[0])
    # Off the card the allocator is not read.
    assert set(taken.counters) == {"fl.bytes.serialized"}


def test_take_drains():
    spans.enable()
    with spans.span("fl.round", round=7):
        spans.count("fl.bytes.serialized", 5)
        spans.count("fl.bytes.serialized", 6)
    spans.count("fl.bytes.serialized", 1)
    first = spans.take()
    assert [s.name for s in first.spans] == ["fl.round"]
    assert first.counters == {"fl.bytes.serialized": {7: 11, None: 1}}
    second = spans.take()
    assert second.spans == [] and second.counters == {}
    assert second.offset_ns == first.offset_ns


@pytest.mark.parametrize("call", [spans.take, spans.enable])
def test_records_are_not_swapped_inside_an_open_span(call):
    spans.enable()
    with spans.span("fl.round", round=1):
        with pytest.raises(RuntimeError, match="fl.round"):
            call()
        with spans.span("fl.fold"):
            pass
    taken = spans.take()
    assert [(s.name, s.parent) for s in taken.spans] == [("fl.round", None), ("fl.fold", 0)]


def test_spans_of_another_thread_have_their_own_parents():
    spans.enable()
    seen = {}

    def other():
        with spans.span("fl.train", silo="b") as s:
            seen["s"] = s

    with spans.span("fl.round", round=1):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert seen["s"].parent is None and seen["s"].round is None


def test_offset_lays_spans_on_the_wall_clock():
    spans.enable()
    wall0 = time.time_ns()
    with spans.span("fl.round", round=1):
        pass
    wall1 = time.time_ns()
    taken = spans.take()
    (s,) = taken.spans
    # Within a millisecond of the wall clock's readings around it.
    assert wall0 - 1_000_000 <= s.start_ns + taken.offset_ns <= wall1 + 1_000_000


def test_spans_open_no_profiler_range():
    from torch.profiler import ProfilerActivity, profile

    server = _server("int8")
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        server.run(1)
    taken = spans.take()
    assert _by_name(taken, "fl.round")
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not [n for n in names if n.startswith("fl.")]
