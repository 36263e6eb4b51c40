"""The slice as a whole: the same FL run through both packages.

Reduced FEMNIST (2 conv + 2 x 64 FC), 3 silos with ragged sample counts,
3 rounds of AdamW, client checkpoints every round, a server checkpoint
every 2 rounds, the server killed at round 2 and restored (§4.3).  Both
servers start from the reference's initial weights and read the same
numpy batches; the reference folds through its Pallas kernel in
interpret mode, the port through its kernel's plain version.

Tolerances, and why:
- Losses agree to 1e-4 and final parameters to 1e-4 absolute.  The two
  frameworks sum convolution and matmul gradients in other orders
  (~1e-6 relative), and AdamW divides by sqrt(v): where a gradient
  element is tiny, its update is ~lr * sign(g), so a rounding-level
  difference in g can move that element by up to lr per step.  With
  lr = 1e-4 the largest difference seen after the 3 rounds is ~3e-6;
  at lr = 1e-3 it was ~4e-4, which is why the run uses 1e-4.
- Accuracy agrees to 1/96 (one test example of the 96): a prediction
  whose two best logits nearly tie may flip under those differences.
- Event traces, restore sources and message byte counts are exact.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ClientCheckpointManager as JaxClientCkpt
from repro.checkpoint import ServerCheckpointManager as JaxServerCkpt
from repro.data import make_classification_silos as jax_silos
from repro.federated import AggregationEngine as JaxEngine
from repro.federated import FLClient as JaxClient
from repro.federated import FLServer as JaxServer
from repro.models import fl_models as jm
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch.checkpoint import ClientCheckpointManager, ServerCheckpointManager
from repro_torch.convert import params_from_numpy
from repro_torch.core.events import EventBus
from repro_torch.data import make_classification_silos
from repro_torch.federated import AsyncRoundEngine, FLClient, FLServer, InstantSchedule
from repro_torch.federated.async_server import ClientArrival
from repro_torch.models import fl_models as tm
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_leaves

SAMPLES = [(64, 32), (48, 16), (40, 48)]
N_ROUNDS = 3
FAULT_ROUND = 2
LR = 1e-4
LOSS_TOL = 1e-4
PARAM_TOL = 1e-4
ACC_TOL = 1.0 / sum(n for _, n in SAMPLES) + 1e-12
_TIME_FIELDS = {"time_s", "span_s", "overhead_s"}


def _jax_run(tmp, params0):
    cfg = jm.FemnistConfig(n_fc=2, fc_width=64)

    def loss_fn(p, b):
        return jm.softmax_cross_entropy(jm.femnist_forward(p, b[0], cfg), b[1])

    def eval_fn(p, b):
        logits = jm.femnist_forward(p, b[0], cfg)
        n = b[0].shape[0]
        return {"acc_sum": jnp.mean((jnp.argmax(logits, -1) == b[1]).astype(jnp.float32)) * n,
                "loss_sum": jm.softmax_cross_entropy(logits, b[1]) * n}

    opt = jax_make_optimizer("adamw", LR)
    clients = [
        JaxClient(s.client_id, s, loss_fn, opt, batch_size=16, eval_fn=eval_fn,
                  batch_fn=lambda b: (jnp.asarray(b[0]), jnp.asarray(b[1])))
        for s in jax_silos(3, 62, (28, 28, 1), SAMPLES, seed=0)
    ]
    server = JaxServer(
        clients, params0,
        server_ckpt=JaxServerCkpt(os.path.join(tmp, "jl"), os.path.join(tmp, "jr"),
                                  interval_rounds=2),
        client_ckpts={c.client_id: JaxClientCkpt(os.path.join(tmp, "j" + c.client_id))
                      for c in clients},
        fault_hook=lambda r: "s" if r == FAULT_ROUND else None,
        measure_round_messages=True,
        agg_engine=JaxEngine(use_pallas=True, interpret=True),
    )
    return server, server.run(N_ROUNDS)


def _port_run(tmp, params0):
    cfg = tm.FemnistConfig(n_fc=2, fc_width=64)

    def loss_fn(p, b):
        return tm.softmax_cross_entropy(tm.femnist_forward(p, b[0], cfg), b[1])

    def eval_fn(p, b):
        logits = tm.femnist_forward(p, b[0], cfg)
        n = b[0].shape[0]
        return {"acc_sum": (logits.argmax(-1) == b[1]).float().mean() * n,
                "loss_sum": tm.softmax_cross_entropy(logits, b[1]) * n}

    opt = make_optimizer("adamw", LR)
    clients = [
        FLClient(s.client_id, s, loss_fn, opt, batch_size=16, eval_fn=eval_fn, device="cpu")
        for s in make_classification_silos(3, 62, (28, 28, 1), SAMPLES, seed=0)
    ]
    server = FLServer(
        clients, params_from_numpy(params0, device="cpu"),
        server_ckpt=ServerCheckpointManager(os.path.join(tmp, "tl"), os.path.join(tmp, "tr"),
                                            interval_rounds=2),
        client_ckpts={c.client_id: ClientCheckpointManager(os.path.join(tmp, "t" + c.client_id))
                      for c in clients},
        fault_hook=lambda r: "s" if r == FAULT_ROUND else None,
        measure_round_messages=True,
        device="cpu",
    )
    return server, server.run(N_ROUNDS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("fl_runs"))
    params0 = jm.init_femnist_cnn(jax.random.PRNGKey(0), jm.FemnistConfig(n_fc=2, fc_width=64))
    jserver, jres = _jax_run(tmp, params0)
    tserver, tres = _port_run(tmp, jax.tree.map(np.asarray, params0))
    return jserver, jres, tserver, tres


def test_metrics_agree_per_round(runs):
    _, jres, _, tres = runs
    assert len(tres.rounds) == len(jres.rounds) == N_ROUNDS
    for t, j in zip(tres.rounds, jres.rounds):
        assert t.round_idx == j.round_idx
        assert sorted(t.metrics) == sorted(j.metrics) == ["acc", "loss"]
        assert abs(t.metrics["loss"] - j.metrics["loss"]) < LOSS_TOL
        assert abs(t.metrics["acc"] - j.metrics["acc"]) <= ACC_TOL


def test_final_params_agree(runs):
    _, jres, _, tres = runs
    got = tree_leaves(tres.final_params)
    want = jax.tree.leaves(jres.final_params)
    assert len(got) == len(want)
    for t, j in zip(got, want):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=PARAM_TOL, rtol=0)


def test_restart_source_equal(runs):
    _, jres, _, tres = runs
    assert [r.restarted_from for r in tres.rounds] == [r.restarted_from for r in jres.rounds]
    assert tres.rounds[FAULT_ROUND - 1].restarted_from == "client:client_0"


def _event_key(e):
    fields = {k: v for k, v in dataclasses.asdict(e).items() if k not in _TIME_FIELDS}
    return type(e).__name__, fields


def test_event_traces_equal(runs):
    jserver, _, tserver, _ = runs
    got = [_event_key(e) for e in tserver.bus.trace]
    want = [_event_key(e) for e in jserver.bus.trace]
    assert got == want
    assert ("RecoveryCompleted", {"task": "s", "resume_round": FAULT_ROUND, "delay_s": 0.0,
                                  "restored_from": "client_local:client_0"}) in got


def test_message_byte_counts_equal(runs):
    _, jres, _, tres = runs
    for t, j in zip(tres.rounds, jres.rounds):
        assert dataclasses.asdict(t.message_log) == dataclasses.asdict(j.message_log)
        assert t.message_log.total_bytes(3) == j.message_log.total_bytes(3)


def test_fold_accounting_and_checkpoints(runs):
    jserver, jres, tserver, tres = runs
    for t, j in zip(tres.rounds, jres.rounds):
        assert sorted(t.fold_times_s) == sorted(j.fold_times_s)
        assert t.idle_s == j.idle_s == 0.0 and t.agg_time_s > 0
    assert tserver.agg_engine.stats.n_calls == N_ROUNDS
    assert tserver.agg_engine.stats.total_bytes == jserver.agg_engine.stats.total_bytes
    assert tserver.server_ckpt.latest_durable().round_idx == 2
    assert {cid: m.latest().round_idx for cid, m in tserver.client_ckpts.items()} == \
        {cid: N_ROUNDS for cid in tserver.client_ckpts}


# ---------------------------------------------------------------------------
# The round engine's degenerate branch and what it leaves to later slices
# ---------------------------------------------------------------------------

def _results():
    from repro_torch.federated import ClientResult

    return [ClientResult(f"c{i}", {"w": torch.full((5,), float(i))}, 10 * (i + 1), 0.0)
            for i in range(3)]


def test_degenerate_fold_publishes_trace():
    bus = EventBus()
    report = AsyncRoundEngine(bus=bus).fold_round(4, _results(), InstantSchedule())
    np.testing.assert_allclose(report.params["w"].numpy(), (0 * 10 + 1 * 20 + 2 * 30) / 60)
    assert [type(e).__name__ for e in bus.trace] == \
        ["UpdateArrived", "UpdateFolded"] * 3 + ["RoundClosed"]
    assert [e.weight for e in report.events] == [10.0, 20.0, 30.0]


class _Late(InstantSchedule):
    def round_arrivals(self, round_idx, client_ids):
        return {cid: ClientArrival(cid, 1.5) for cid in client_ids}


@pytest.mark.parametrize("kw", [{"emit_partial": True}])
def test_later_branches_raise_not_implemented(kw):
    args = {"schedule": InstantSchedule(), **kw}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        AsyncRoundEngine().fold_round(1, _results(), **args)


@pytest.mark.parametrize("branch", ["deadline", "base_params", "spread_schedule"])
def test_branches_of_later_slices_now_fold(branch):
    """The branches that raised in the first slice fold the round: a
    deadline, a delta base, and arrivals spread in time all give the
    barrier's weighted average and the streaming trace."""
    from repro_torch.federated.async_server import FixedDeadline

    args = {"schedule": InstantSchedule()}
    if branch == "deadline":
        args["deadline"] = FixedDeadline(t_round_s=1.0)
    elif branch == "base_params":
        args["base_params"] = {"w": torch.zeros(5)}
    else:
        args["schedule"] = _Late()
    bus = EventBus()
    report = AsyncRoundEngine(bus=bus, fold_cost_s=0.25).fold_round(1, _results(), **args)
    np.testing.assert_allclose(report.params["w"].numpy(), (0 * 10 + 1 * 20 + 2 * 30) / 60,
                               rtol=1e-6)
    arrival = 1.5 if branch == "spread_schedule" else 0.0
    assert report.round_span_s == pytest.approx(arrival + 3 * 0.25)
    assert [e.fold_end_s for e in report.events] == \
        pytest.approx([arrival + 0.25 * (i + 1) for i in range(3)])
    names = [type(e).__name__ for e in bus.trace]
    assert names.count("UpdateFolded") == 3 and names[-1] == "RoundClosed"
    assert ("DeadlineExpired" in names) == (branch == "deadline")
