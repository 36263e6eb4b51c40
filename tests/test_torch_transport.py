"""The port's wall-clock socket transport against the reference's.

Mirrors tests/test_transport.py, its four ``test_builder_*`` tests on the
port's ``Experiment`` (the other scenarios build the driver directly, as
the builder does; ``test_builder_live_target_matches_the_reference_chain``
serves one chain from both packages).  Each scenario's live run is held
against the
port's in-process ``AsyncFLServer`` as the reference's test holds its
own, and where the reference's test does so, also against the
reference's ``AsyncFLServer`` on the same clients: trace signatures
equal, params within the reference test's 1e-5.

Then the cross-package tests: a frame written by either package's
``send_frame`` is byte-equal to the other's, and one live round whose
cohort holds a reference (JAX) worker and a port worker runs under each
package's driver, with params within 1e-5 of an all-JAX round and the
message logs equal byte for byte.

Sizing against a loaded machine (the suite runs under ``-n 6``): every
client is warmed up before a timed round; a reply timeout is at least
100x the work of the silo it must not catch (a few ms of training on a
3-weight model), and a silo that must miss it sleeps at least a second
past it; assertions read the recorded schedule and the events.  Where
a test needs c0's reply before c1's, c1 trains only after the driver has
taken c0's reply off its transport (``ordered_transport``), never after
a sleep.
"""
import dataclasses
import socket
import threading
import time

import numpy as np
import pytest
import torch

from conftest import make_toy_app, make_toy_env
from repro.federated import AsyncFLServer as JaxAsyncServer
from repro.federated import DeterministicSchedule as JaxDeterministic
from repro.federated.async_server import ArrivalSchedule as JaxArrivalSchedule
from repro.federated.async_server import ClientArrival as JaxArrival
from repro.federated.transport import LiveRoundDriver as JaxDriver
from repro.federated.transport import SocketTransport as JaxSocketTransport
from repro.federated.transport import recv_frame as jax_recv_frame
from repro.federated.transport import run_client_worker as jax_run_client_worker
from repro.federated.transport import send_frame as jax_send_frame
from repro_torch.core import CostModel, Experiment
from repro_torch.core.events import (
    DeadlineExpired,
    RevocationOccurred,
    RoundClosed,
    RoundDispatched,
    StragglerEscalated,
    UpdateArrived,
    UpdateFolded,
)
from repro_torch.federated import (
    AsyncFLServer,
    DeterministicSchedule,
    FixedDeadline,
    FLClient,
    LiveRoundDriver,
    ProcessWorkerPool,
    SocketTransport,
    ThreadWorkerPool,
)
from repro_torch.federated.async_server import ArrivalSchedule, ClientArrival
from repro_torch.federated.transport import (
    MSG_C_TRAIN,
    recv_frame,
    run_client_worker,
    send_frame,
)
from repro_torch.optim import make_optimizer
from test_torch_core_models import port_app, port_env



# ---------------------------------------------------------------------------
# Scenario helpers: real FLClients over a tiny linear model
# ---------------------------------------------------------------------------

class ArraySilo:
    """In-memory silo yielding (x, y) numpy minibatches."""

    def __init__(self, client_id, x, y):
        self.client_id = client_id
        self.x = x
        self.y = y

    def batches(self, batch_size, split="train"):
        for i in range(0, len(self.x), batch_size):
            yield (self.x[i:i + batch_size], self.y[i:i + batch_size])


class PacedClient(FLClient):
    """Real FLClient with a controlled reply delay and crash injection,
    as tests/test_transport.py's: ``delay_s`` (a float, or one per
    attempt, the last repeating) sleeps before training; attempts in
    ``crash_on_attempts`` raise out of train() (the §4.3 crash signal
    behind the socket), ``crash_eval_on_attempts`` out of evaluate()."""

    def __init__(self, *args, delay_s=0.0, crash_on_attempts=(),
                 crash_eval_on_attempts=(), **kwargs):
        super().__init__(*args, **kwargs)
        self.delay_s = delay_s
        self._crash_on = set(crash_on_attempts)
        self._crash_eval_on = set(crash_eval_on_attempts)
        self._attempts = 0
        self._eval_attempts = 0
        # Deterministic cross-silo ordering under any machine load: a
        # client acquires its semaphore before training; the driver's
        # transport releases it (``ordered_transport``).
        self.acquire_sem = None

    def warm_up(self, params):
        """One train and one evaluate outside the attempt counts, so no
        timed round pays a first call's set-up."""
        FLClient.train(self, params)
        FLClient.evaluate(self, params)
        return self

    def train(self, global_params):
        self._attempts += 1
        if self._attempts in self._crash_on:
            raise RuntimeError("silo VM revoked (injected)")
        if self.acquire_sem is not None:
            assert self.acquire_sem.acquire(timeout=60.0)
        delay = self.delay_s
        if not isinstance(delay, (int, float)):
            delay = delay[min(self._attempts, len(delay)) - 1]
        if delay:
            time.sleep(delay)
        return super().train(global_params)

    def evaluate(self, aggregated_params):
        self._eval_attempts += 1
        if self._eval_attempts in self._crash_eval_on:
            raise RuntimeError("silo VM revoked during evaluation (injected)")
        return super().evaluate(aggregated_params)


def _linear_loss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] - y) ** 2)


def silo_arrays(delays, n_examples=(12, 20), seed=0):
    """Each silo's (x, y) as tests/test_transport.py draws them."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, cid in enumerate(delays):
        n = n_examples[i % len(n_examples)]
        x = rng.standard_normal((n, 3)).astype(np.float32)
        y = rng.standard_normal((n,)).astype(np.float32)
        out[cid] = (x, y)
    return out


def make_paced_clients(delays, crash_on=None, n_examples=(12, 20), seed=0,
                       device="cpu"):
    """Port FLClients on the same data as tests/test_transport.py's, warmed up."""
    crash_on = crash_on or {}
    clients = []
    for cid, (x, y) in silo_arrays(delays, n_examples, seed).items():
        clients.append(PacedClient(
            cid, ArraySilo(cid, x, y), _linear_loss, make_optimizer("sgdm", 1e-2),
            batch_size=8, delay_s=delays[cid], crash_on_attempts=crash_on.get(cid, ()),
            device=device,
        ).warm_up(init_params(device)))
    return clients


def jax_paced_clients(delays, n_examples=(12, 20), seed=0):
    """The reference's clients on the same data (virtual-clock runs only)."""
    from test_transport import make_paced_clients as jax_make

    return jax_make({cid: 0.0 for cid in delays}, n_examples=n_examples, seed=seed)


def init_params(device="cpu"):
    return {"w": torch.zeros((3,), dtype=torch.float32, device=device)}


def jax_init_params():
    from test_transport import init_params as jax_init

    return jax_init()


def ordered_transport(base, first, second):
    """A ``base`` transport (either package's ``SocketTransport``) on which
    ``second`` trains only after the driver has recorded ``first``'s
    c_msg_train, every round: ``second`` waits on a semaphore before
    training, and the transport releases it when the driver polls again
    after the batch that carried ``first``'s reply (so the driver has taken
    that reply's arrival time).  No sleep orders the two."""
    sem = threading.Semaphore(0)
    second.acquire_sem = sem
    first_id = str(first.client_id)

    class Ordered(base):
        released_next_poll = False

        def poll(self, timeout_s):
            if self.released_next_poll:
                self.released_next_poll = False
                sem.release()
            events = super().poll(timeout_s)
            if any(ev.kind == "message" and ev.client_id == first_id
                   and ev.header.get("kind") == MSG_C_TRAIN for ev in events):
                self.released_next_poll = True
            return events

    return Ordered()


def live_driver(clients, *, chaos=None, reconnect=None, compression=None, device="cpu",
                **kwargs):
    """What ``Experiment().transport(...).serve(clients, init_params())``
    builds in the reference: a thread pool (clients wrapped by the plan
    when chaos is on) and a LiveRoundDriver on a loopback transport."""
    live_clients = chaos.wrap_clients(clients) if chaos is not None else clients
    pool = ThreadWorkerPool(live_clients, init_params(device), reconnect=reconnect,
                            compression=compression, device=device)
    return LiveRoundDriver(pool, init_params(device), chaos=chaos, compression=compression,
                           device=device, **kwargs)


def trace_signature(trace):
    """Event sequence modulo timestamps: (type, round, task, attempt)."""
    return [
        (type(e).__name__, getattr(e, "round_idx", None), getattr(e, "task", None),
         getattr(e, "attempt", None))
        for e in trace
    ]


def _w(params):
    w = params["w"]
    return w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)


def assert_params_close(got, want):
    np.testing.assert_allclose(_w(got), _w(want), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------

def test_frame_roundtrip_over_socketpair():
    a, b = socket.socketpair()
    try:
        header = {"kind": "c_msg_train", "round_idx": 3, "n_samples": 17}
        payload = b"\x00\x01" * 513
        wire = send_frame(a, header, payload)
        got_header, got_payload = recv_frame(b)
        assert got_header == header
        assert got_payload == payload
        assert wire == 8 + (wire - 8 - len(payload)) + len(payload)
        a.close()
        assert recv_frame(b) is None  # clean EOF at a frame boundary
    finally:
        a.close()
        b.close()


def test_transport_requires_start():
    transport = SocketTransport()
    with pytest.raises(RuntimeError):
        _ = transport.address
    with pytest.raises(RuntimeError):
        transport.poll(0.0)


# ---------------------------------------------------------------------------
# Loopback round-trip equivalence vs the in-process drivers
# ---------------------------------------------------------------------------

def test_loopback_run_matches_in_process_async_server():
    """Two real FLClient workers over loopback give the final params and
    the event sequence (modulo wall-clock times) of the in-process
    AsyncFLServer on the same scenario, in the port and in the
    reference."""
    delays = {"c0": 0.0, "c1": 0.0}
    clients = make_paced_clients(delays)
    driver = live_driver(clients, reply_timeout_s=60.0,  # c0's reply always lands first
                         transport=ordered_transport(SocketTransport, clients[0], clients[1]))
    assert isinstance(driver, LiveRoundDriver)
    with driver:
        live = driver.run(2)

    schedule = {"c0": 0.01, "c1": 0.02}
    server = AsyncFLServer(make_paced_clients(delays), init_params(),
                           schedule=DeterministicSchedule(schedule), device="cpu")
    sim = server.run(2)
    ref = JaxAsyncServer(jax_paced_clients(delays), jax_init_params(),
                         schedule=JaxDeterministic(schedule))
    ref_run = ref.run(2)

    assert_params_close(live.final_params, sim.final_params)
    assert_params_close(live.final_params, ref_run.final_params)
    assert trace_signature(driver.trace) == trace_signature(server.bus.trace)
    assert trace_signature(driver.trace) == trace_signature(ref.bus.trace)
    for rec_live, rec_sim in zip(live.rounds, sim.rounds):
        assert rec_live.metrics.keys() == rec_sim.metrics.keys()
        assert rec_live.metrics["loss"] == pytest.approx(rec_sim.metrics["loss"], rel=1e-4)
    assert set(live.rounds[0].fold_times_s) == {"c0", "c1"}


def test_loopback_survives_injected_crash_via_rerequest():
    """§4.3: a worker that dies mid-round is restarted and its retrained
    update re-requested; the trace shows RevocationOccurred and an
    attempt-2 arrival, as the in-process engines replaying the same
    revocation do."""
    delays = {"c0": 0.0, "c1": 0.0}
    clients = make_paced_clients(delays, crash_on={"c1": (1,)})
    driver = live_driver(clients, reply_timeout_s=60.0,  # c1's re-request lands after c0
                         transport=ordered_transport(SocketTransport, clients[0], clients[1]))
    with driver:
        live = driver.run(2)

    def revoke_once(arrival, base):
        class RevokeOnce(base):
            def round_arrivals(self, round_idx, client_ids):
                out = {"c0": arrival("c0", 0.01), "c1": arrival("c1", 0.05)}
                if round_idx == 1:
                    out["c1"] = arrival("c1", 0.05, revoke_at_s=0.02)
                return {cid: out[cid] for cid in client_ids}
        return RevokeOnce()

    server = AsyncFLServer(make_paced_clients(delays), init_params(),
                           schedule=revoke_once(ClientArrival, ArrivalSchedule),
                           on_revocation="rerequest", device="cpu")
    sim = server.run(2)
    ref = JaxAsyncServer(jax_paced_clients(delays), jax_init_params(),
                         schedule=revoke_once(JaxArrival, JaxArrivalSchedule),
                         on_revocation="rerequest")
    ref_run = ref.run(2)

    assert driver.fold_reports[0].rerequested == ["c1"]
    assert not driver.fold_reports[0].excluded
    assert "c1" in driver.cohort
    assert_params_close(live.final_params, sim.final_params)
    assert_params_close(live.final_params, ref_run.final_params)
    assert trace_signature(driver.trace) == trace_signature(server.bus.trace)
    assert trace_signature(driver.trace) == trace_signature(ref.bus.trace)
    revs = [e for e in driver.trace if isinstance(e, RevocationOccurred)]
    assert [e.task for e in revs] == ["c1"]
    arrivals = [e for e in driver.trace if isinstance(e, UpdateArrived) and e.task == "c1"]
    assert [e.attempt for e in arrivals] == [2, 1]


def test_crash_with_exhausted_budget_excludes_and_drops_from_cohort():
    delays = {"c0": 0.0, "c1": 0.1}
    clients = make_paced_clients(delays, crash_on={"c1": (1, 2)})
    driver = live_driver(clients, reply_timeout_s=60.0, max_rerequests=1)
    with driver:
        live = driver.run(2)
    assert driver.fold_reports[0].excluded == ["c1"]
    assert driver.cohort == ["c0"]
    dispatches = [e for e in driver.trace if isinstance(e, RoundDispatched)]
    assert [e.n_clients for e in dispatches] == [2, 1]
    assert len(live.rounds) == 2


def test_reply_timeout_maps_to_recovery_and_straggler_escalation():
    """A silent silo is a §4.3 suspected fault for the round (revoked,
    excluded) but stays in the cohort; the timeout escalates through the
    engine's StragglerTracker as §4.4 StragglerEscalated + on_straggler.
    The timeout is 2 s against c0's few ms; c1 sleeps 5 s."""
    escalated = []
    clients = make_paced_clients({"c0": 0.0, "c1": 5.0})
    driver = live_driver(clients, reply_timeout_s=2.0, escalate_after=1,
                         on_straggler=lambda cid, r: escalated.append((cid, r)))
    with driver:
        live = driver.run(1)
    assert driver.fold_reports[0].excluded == ["c1"]
    assert driver.cohort == ["c0", "c1"]
    revs = [e for e in driver.trace if isinstance(e, RevocationOccurred)]
    assert [e.task for e in revs] == ["c1"]
    escs = [e for e in driver.trace if isinstance(e, StragglerEscalated)]
    assert [(e.task, e.consecutive_misses) for e in escs] == [("c1", 1)]
    assert escalated == [("c1", 1)]
    folded = [e.task for e in driver.trace if isinstance(e, UpdateFolded)]
    assert folded == ["c0"]
    assert len(live.rounds) == 1


def test_deadline_policy_parks_measured_late_arrival_for_next_round():
    """RoundDeadline policies run unchanged on measured arrivals: a reply
    after T_round (1 s; c0 takes a few ms, c1 sleeps 3 s) is parked and
    folds stale into the next round."""
    clients = make_paced_clients({"c0": 0.0, "c1": 3.0})
    driver = live_driver(clients, round_deadline=FixedDeadline(t_round_s=1.0, min_clients=1))
    with driver:
        live = driver.run(2)
    first, second = driver.fold_reports
    assert first.carried_over == ["c1"]
    assert second.carried_in == ["c1"]
    assert live.rounds[0].carried_over == ["c1"]
    assert live.rounds[1].carried_in == ["c1"]
    stale = [e for e in driver.trace
             if isinstance(e, UpdateFolded) and e.origin_round is not None]
    assert [(e.task, e.origin_round, e.round_idx) for e in stale] == [("c1", 1, 2)]
    deadlines = [e for e in driver.trace if isinstance(e, DeadlineExpired)]
    assert deadlines and deadlines[0].late == ("c1",)
    closed = [e for e in driver.trace if isinstance(e, RoundClosed)]
    assert closed[0].carried_over == ("c1",) and closed[1].carried_in == ("c1",)


# ---------------------------------------------------------------------------
# Measured message sizes -> CostModel (Eq. 6 on real payloads)
# ---------------------------------------------------------------------------

def test_measured_message_sizes_feed_cost_model():
    cm = CostModel(port_env(make_toy_env()), port_app(make_toy_app()), 0.5)
    cost_max_before = cm.cost_max()
    clients = make_paced_clients({"c0": 0.0, "c1": 0.05})
    driver = live_driver(clients, reply_timeout_s=60.0, cost_model=cm)
    with driver:
        live = driver.run(1)
    log = live.rounds[0].message_log
    assert log is not None
    assert log.s_msg_train_bytes == log.s_msg_aggreg_bytes > 0
    assert log.c_msg_train_bytes == log.s_msg_train_bytes
    assert 0 < log.c_msg_test_bytes < log.s_msg_train_bytes
    assert cm.app.messages.s_msg_train_gb == pytest.approx(log.s_msg_train_bytes / 1e9)
    assert cm.app.messages.c_msg_test_gb == pytest.approx(log.c_msg_test_bytes / 1e9)
    assert cm.cost_max() != cost_max_before


# ---------------------------------------------------------------------------
# Builder surface (tests/test_transport.py's test_builder_* tests)
# ---------------------------------------------------------------------------

def test_builder_transport_validation():
    with pytest.raises(ValueError, match="kind"):
        Experiment().transport(kind="carrier-pigeon")
    with pytest.raises(ValueError, match="on_revocation"):
        Experiment().transport(on_revocation="retry-forever")
    with pytest.raises(ValueError, match="reply_timeout_s"):
        Experiment().transport(reply_timeout_s=0.0)
    with pytest.raises(ValueError, match="max_rerequests"):
        Experiment().transport(max_rerequests=-1)


def test_builder_rejects_schedule_with_transport():
    clients = make_paced_clients({"c0": 0.0})
    with pytest.raises(ValueError, match="virtual-clock"):
        Experiment().transport().serve(
            clients, init_params(), schedule=DeterministicSchedule(0.0), device="cpu"
        )


def test_builder_transport_worker_kind_type_guards():
    clients = make_paced_clients({"c0": 0.0})
    with pytest.raises(TypeError, match="factory"):
        Experiment().transport(kind="process").serve(clients, init_params(), device="cpu")
    with pytest.raises(TypeError, match="FLClient objects"):
        Experiment().transport(kind="thread").serve(
            {"c0": lambda: clients[0]}, init_params(), device="cpu"
        )
    with pytest.raises(TypeError, match="transport"):
        Experiment().serve({"c0": lambda: clients[0]}, init_params(), device="cpu")


def test_builder_chains_do_not_alias_transport():
    base = Experiment()
    with_transport = base.transport()
    assert base._transport is None
    assert with_transport._transport is not None
    # A later setter on the transported chain keeps the transport.
    assert with_transport.rounds(3)._transport is not None


def test_builder_live_target_matches_the_reference_chain():
    """The same chain, ``.transport(reply_timeout_s=60).aggregation(
    compression="int8")``, served by both packages: the port's driver and
    pool take the chain's settings and ``device=``, and two loopback rounds
    give the reference's params (1e-5), message logs and trace signature."""
    from repro.core import Experiment as JaxExperiment

    delays = {"c0": 0.0, "c1": 0.0}
    clients = make_paced_clients(delays)
    driver = (Experiment().transport(reply_timeout_s=60.0).aggregation(compression="int8")
              .serve(clients, init_params(), device="cpu"))
    assert isinstance(driver, LiveRoundDriver) and isinstance(driver.workers, ThreadWorkerPool)
    assert driver.reply_timeout_s == 60.0 and driver.compression.codec == "int8"
    assert driver.params["w"].device.type == "cpu"
    assert driver.workers._template["w"].device.type == "cpu"
    driver.transport = ordered_transport(SocketTransport, clients[0], clients[1])
    with driver:
        res = driver.run(2)

    from test_transport import make_paced_clients as jax_make

    jclients = jax_make(delays)
    jdriver = (JaxExperiment().transport(reply_timeout_s=60.0).aggregation(compression="int8")
               .serve(jclients, jax_init_params()))
    jdriver.transport = ordered_transport(JaxSocketTransport, jclients[0], jclients[1])
    with jdriver:
        jres = jdriver.run(2)
    assert_params_close(res.final_params, jres.final_params)
    assert [dataclasses.asdict(r.message_log) for r in res.rounds] == \
        [dataclasses.asdict(r.message_log) for r in jres.rounds]
    assert trace_signature(driver.trace) == trace_signature(jdriver.trace)


# ---------------------------------------------------------------------------
# Worker pool plumbing
# ---------------------------------------------------------------------------

def test_thread_pool_rejects_duplicate_ids():
    clients = make_paced_clients({"c0": 0.0})
    with pytest.raises(ValueError, match="duplicate"):
        ThreadWorkerPool(clients + clients, init_params(), device="cpu")


def test_non_consecutive_timeouts_do_not_escalate():
    """An on-time reply clears the timeout streak without a RoundDeadline:
    timeouts in rounds 1 and 3 with an on-time round 2 are not
    consecutive.  c1 sleeps 3 s against a 2 s timeout: it misses the
    train window by 1 s and still lands its eval reply inside the 2 s
    eval window, so round 2 starts with it idle."""
    clients = make_paced_clients({"c0": 0.0, "c1": 0.0})
    clients[1].delay_s = [3.0, 0.0, 3.0]
    driver = live_driver(clients, reply_timeout_s=2.0, escalate_after=2)
    with driver:
        driver.run(3)
    assert [bool(r.excluded) for r in driver.fold_reports] == [True, False, True]
    escs = [e for e in driver.trace if isinstance(e, StragglerEscalated)]
    assert escs == []
    assert driver._engine.stragglers.streak_of("c1") == 1


def test_eval_phase_crash_restarts_worker_and_keeps_silo():
    clients = make_paced_clients({"c0": 0.0, "c1": 0.1})
    clients[1]._crash_eval_on = {1}
    driver = live_driver(clients, reply_timeout_s=60.0)
    with driver:
        live = driver.run(2)
    assert driver.cohort == ["c0", "c1"]
    assert set(live.rounds[0].fold_times_s) == {"c0", "c1"}
    assert set(live.rounds[1].fold_times_s) == {"c0", "c1"}
    assert live.rounds[0].metrics and live.rounds[1].metrics


def test_crash_recovery_overrunning_reply_window_is_not_a_strike():
    """A silo whose §4.3 recovery overran reply_timeout_s is excluded but
    not counted as a §4.4 miss.  The retrain after the restart sleeps
    5 s against a 2 s window."""
    clients = make_paced_clients({"c0": 0.0, "c1": 0.0}, crash_on={"c1": (1,)})
    clients[1].delay_s = 5.0
    driver = live_driver(clients, reply_timeout_s=2.0, escalate_after=1)
    with driver:
        driver.run(1)
    assert driver.fold_reports[0].excluded == ["c1"]
    escs = [e for e in driver.trace if isinstance(e, StragglerEscalated)]
    assert escs == []
    assert driver._engine.stragglers.streak_of("c1") == 0
    revs = [e for e in driver.trace if isinstance(e, RevocationOccurred)]
    assert [e.task for e in revs] == ["c1"]


# Module-level factories: multiprocessing spawn pickles them by reference
# and rebuilds the clients inside the child process.
def _process_client_c0():
    return make_paced_clients({"c0": 0.0}, seed=0)[0]


def _process_client_c1():
    return make_paced_clients({"c1": 0.0}, seed=1)[0]


def test_process_worker_pool_round_trip():
    """Real OS processes build their FLClient from a picklable factory and
    speak the same wire protocol; the child rebuilds the template."""
    pool = ProcessWorkerPool({"c0": _process_client_c0, "c1": _process_client_c1},
                             init_params(), device="cpu")
    driver = LiveRoundDriver(pool, init_params(), reply_timeout_s=180.0,
                             startup_timeout_s=240.0, device="cpu")
    with driver:
        live = driver.run(1)
    assert len(live.rounds) == 1
    assert set(live.rounds[0].fold_times_s) == {"c0", "c1"}
    assert trace_signature(driver.trace)[0][0] == "RoundDispatched"
    folded = {e.task for e in driver.trace if isinstance(e, UpdateFolded)}
    assert folded == {"c0", "c1"}


def test_driver_restarts_are_bounded_by_cohort(monkeypatch):
    """restart() returning False (no replacement capacity) maps the crash
    onto exclusion instead of hanging the round."""
    clients = make_paced_clients({"c0": 0.0, "c1": 0.1}, crash_on={"c1": (1,)})
    pool = ThreadWorkerPool(clients, init_params(), device="cpu")
    monkeypatch.setattr(pool, "restart", lambda cid, addr, host=None: False)
    driver = LiveRoundDriver(pool, init_params(), reply_timeout_s=60.0, device="cpu")
    with driver:
        live = driver.run(1)
    assert driver.fold_reports[0].excluded == ["c1"]
    assert driver.cohort == ["c0"]
    assert len(live.rounds) == 1


def test_process_pool_pickles_shapes_not_weights():
    """The spawned child gets the template's shapes and dtypes only
    (bfloat16 included) and rebuilds it on the pool's device."""
    import pickle

    from repro_torch.federated.transport import _LeafSpec

    template = {"a": torch.ones((4, 3), dtype=torch.bfloat16), "b": [torch.zeros(7)]}
    pool = ProcessWorkerPool({}, template, device="cpu")
    spec = pickle.loads(pickle.dumps(pool._template_spec))
    assert spec == {"a": _LeafSpec((4, 3), torch.bfloat16), "b": [_LeafSpec((7,), torch.float32)]}
    built = spec["a"].build(torch.device("cpu"))
    assert built.shape == (4, 3) and built.dtype == torch.bfloat16
    assert built.untyped_storage().nbytes() == 2


# ---------------------------------------------------------------------------
# Across packages: frames and mixed cohorts
# ---------------------------------------------------------------------------

FRAMES = {
    "hello": ({"kind": "hello", "client_id": "femnist_client_3"}, b""),
    "c_msg_train": ({"kind": "c_msg_train", "round_idx": 3, "client_id": "c1", "n_samples": 1050,
                     "train_time_s": 0.123456789, "codec": "int8",
                     "dense_bytes": 656_748_280}, bytes(range(256)) * 40),
    "structured": ({"kind": "c_msg_train", "round_idx": 70_000, "client_id": "c0",
                    "n_samples": 0, "train_time_s": -0.0, "structured": 1,
                    "dense_bytes": 2 ** 33,
                    "group_bytes": {"lora_a": 4096, "lora_b": 70000, "adapters/0": 5},
                    "group_dense": {"lora_a": 1 << 20, "lora_b": 2 ** 32 + 1}}, b"\xff" * 3),
    "floats": ({"kind": "c_msg_test", "round_idx": 1, "eval_time_s": 1e-300,
                "x": float("inf"), "y": -2.5, "z": 1.0 / 3.0, "neg": -129, "big": -2 ** 40},
               b""),
    "ping": ({"kind": "ping", "seq": 65536}, b""),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_send_frame_is_byte_equal_across_packages(name):
    header, payload = FRAMES[name]
    wires = []
    for send in (send_frame, jax_send_frame):
        a, b = socket.socketpair()
        try:
            n = send(a, header, payload)
            a.close()
            chunks = []
            while True:
                c = b.recv(1 << 16)
                if not c:
                    break
                chunks.append(c)
            wire = b"".join(chunks)
            assert len(wire) == n
            wires.append(wire)
        finally:
            a.close()
            b.close()
    assert wires[0] == wires[1]
    for recv in (recv_frame, jax_recv_frame):
        a, b = socket.socketpair()
        try:
            a.sendall(wires[0])
            got = recv(b)
            assert got[0] == header and bytes(got[1]) == payload
        finally:
            a.close()
            b.close()


class MixedPool:
    """A WorkerPool whose cohort runs each package's worker loop: each
    silo is ``(run_client_worker, client, template)`` on a thread.
    ``order`` is the (first, second) pair whose replies the driver's
    transport orders."""

    def __init__(self, workers, compression=None, order=None):
        self._workers = dict(workers)
        self._compression = compression
        self.order = order
        self._threads = []

    @property
    def client_ids(self):
        return list(self._workers)

    def host_of(self, client_id):
        return None

    def _spawn(self, cid, address):
        run, client, template = self._workers[cid]
        t = threading.Thread(target=run, args=(client, template, address),
                             kwargs={"compression": self._compression}, daemon=True)
        self._threads.append(t)
        t.start()

    def launch(self, address):
        for cid in self._workers:
            self._spawn(cid, address)

    def restart(self, client_id, address, host=None):
        self._spawn(client_id, address)
        return True

    def shutdown(self):
        for t in self._threads:
            t.join(timeout=10.0)


def _mixed_workers(jax_ids, codec):
    """Silos c0 and c1 (chained: c0's reply first); those in ``jax_ids``
    are the reference's clients and worker loop, the others the port's."""
    from repro.federated import FLClient as JaxFLClient
    from test_transport import make_paced_clients as jax_make

    delays = {"c0": 0.0, "c1": 0.0}
    port = {c.client_id: c for c in make_paced_clients(delays)}
    ref = {c.client_id: c for c in jax_make(delays)}
    for c in ref.values():
        # The reference's first calls compile: keep them out of the round.
        JaxFLClient.train(c, jax_init_params())
        JaxFLClient.evaluate(c, jax_init_params())
    chosen = {cid: (ref if cid in jax_ids else port)[cid] for cid in delays}
    workers = {}
    for cid, client in chosen.items():
        if cid in jax_ids:
            workers[cid] = (jax_run_client_worker, client, jax_init_params())
        else:
            workers[cid] = (run_client_worker, client, init_params())
    return MixedPool(workers, compression=codec, order=(chosen["c0"], chosen["c1"]))


def _run_driver(kind, pool, codec):
    if kind == "reference":
        driver = JaxDriver(pool, jax_init_params(), reply_timeout_s=60.0, compression=codec,
                           transport=ordered_transport(JaxSocketTransport, *pool.order))
    else:
        driver = LiveRoundDriver(pool, init_params(), reply_timeout_s=60.0, compression=codec,
                                 transport=ordered_transport(SocketTransport, *pool.order),
                                 device="cpu")
    with driver:
        res = driver.run(2)
    return driver, res


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("driver_kind", ["reference", "port"])
def test_mixed_cohort_live_round(driver_kind, codec):
    """One JAX worker (c0) and one port worker (c1) serve the same live
    rounds under either package's driver: params within 1e-5 of an
    all-JAX run, message logs and trace signatures equal."""
    base_driver, base = _run_driver("reference", _mixed_workers({"c0", "c1"}, codec), codec)
    driver, res = _run_driver(driver_kind, _mixed_workers({"c0"}, codec), codec)
    assert_params_close(res.final_params, base.final_params)
    assert [dataclasses.asdict(r.message_log) for r in res.rounds] == \
        [dataclasses.asdict(r.message_log) for r in base.rounds]
    assert trace_signature(driver.trace) == trace_signature(base_driver.trace)
    folded = [e.task for e in driver.trace if type(e).__name__ == "UpdateFolded"]
    assert folded == ["c0", "c1", "c0", "c1"]
    for rec, want in zip(res.rounds, base.rounds):
        assert rec.metrics["loss"] == pytest.approx(want.metrics["loss"], rel=1e-5)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _cuda_params_client(cid):
    """A port client on the card whose train refuses weights off the card."""
    client = make_paced_clients({cid: 0.0}, device="cuda")[0]
    inner = client.train

    def train(global_params):
        if not all(t.is_cuda for t in global_params.values()):
            raise RuntimeError("received params are not on the card")
        return inner(global_params)

    client.train = train
    return client


def _cuda_client_c0():
    return _cuda_params_client("c0")


@pytest.mark.gpu
def test_thread_pool_int8_round_on_card_launches_dequant_fold():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.dequant_fold import dequant_fold

    clients = make_paced_clients({"c0": 0.0, "c1": 0.0}, device="cuda")
    pool = ThreadWorkerPool(clients, init_params("cuda"), compression="int8")
    driver = LiveRoundDriver(pool, init_params("cuda"), reply_timeout_s=60.0,
                             compression="int8")
    before = dequant_fold.launches
    with driver:
        res = driver.run(2)
    assert dequant_fold.launches - before == 4
    assert res.final_params["w"].is_cuda
    folded = [e.task for e in driver.trace if isinstance(e, UpdateFolded)]
    assert sorted(folded) == ["c0", "c0", "c1", "c1"]


@pytest.mark.gpu
def test_process_pool_child_receives_cuda_params():
    """The spawned child rebuilds the template on the card: a train on
    weights off the card would raise, which the driver sees as a crash."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pool = ProcessWorkerPool({"c0": _cuda_client_c0}, init_params("cuda"))
    driver = LiveRoundDriver(pool, init_params("cuda"), reply_timeout_s=180.0,
                             startup_timeout_s=240.0, max_rerequests=0)
    with driver:
        driver.run(1)
    assert [e for e in driver.trace if isinstance(e, RevocationOccurred)] == []
    assert [e.task for e in driver.trace if isinstance(e, UpdateFolded)] == ["c0"]
