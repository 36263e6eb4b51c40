"""The port's control plane and ``Experiment`` builder: the reference's
tests/test_control_plane.py run on ``repro_torch.core``, the serve
targets on the port's servers with tensors on the CPU.

Control plane: typed event bus, module Protocol conformance, the
fluent `Experiment` builder (validation + shim equivalence against the
legacy `SimulationConfig`), trace determinism, and the event-stream
restatements of the PR-3 round invariants (arrival/fold pairing, weight
conservation) for both the simulator and the live async engine."""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import (
    CheckpointPolicy,
    CheckpointSaved,
    ControlPlane,
    CostModel,
    DeadlineExpired,
    DynamicScheduler,
    EventBus,
    Experiment,
    FaultToleranceAPI,
    FaultToleranceModule,
    InitialMapping,
    MapperAPI,
    MultiCloudSimulator,
    NullBus,
    PreSchedulerAPI,
    PreScheduling,
    RevocationOccurred,
    RoundClosed,
    RoundDispatched,
    SchedulerAPI,
    SimulationConfig,
    StragglerEscalated,
    StragglerTracker,
    UpdateArrived,
    UpdateFolded,
    cloudlab_environment,
    shakespeare_application,
    til_application,
)
from repro_torch.core.pre_scheduling import CallableProbe, ProbeResult
from repro_torch.federated import (
    AsyncFLServer,
    AsyncRoundEngine,
    CallableDeadline,
    DeterministicSchedule,
    FixedDeadline,
)

from repro_torch.federated.client import ClientResult, EvalResult
from repro_torch.utils.tree import tree_leaves
from test_torch_core_models import port_toy_app as make_toy_app
from test_torch_core_models import port_toy_env as make_toy_env

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))


# ---------------------------------------------------------------------------
# The port's counterparts of tests/conftest.py's helpers: CPU tensors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cloudlab_env():
    return cloudlab_environment()


def random_tree(rng, shapes):
    """One flat dict tree with the given leaf shapes, drawn as
    conftest.random_tree draws them."""
    return {
        f"leaf{i}": torch.tensor(rng.standard_normal(s), dtype=torch.float32)
        for i, s in enumerate(shapes)
    }


def make_results(n_clients, shapes=((3, 5), (7,)), seed=0, weights=None):
    """N structurally-identical ClientResults with distinct params/weights."""
    rng = np.random.default_rng(seed)
    if weights is None:
        weights = [10 * (i + 1) for i in range(n_clients)]
    return [
        ClientResult(f"c{i}", random_tree(rng, shapes), int(w), 0.0)
        for i, w in enumerate(weights)
    ]


class StubClient:
    """Duck-typed FLClient returning fixed params (no training)."""

    def __init__(self, result):
        self.client_id = result.client_id
        self._result = result

    @classmethod
    def from_params(cls, client_id, params, n_samples):
        return cls(ClientResult(client_id, params, n_samples, 0.0))

    def train(self, global_params):
        return self._result

    def evaluate(self, aggregated_params):
        return EvalResult(self.client_id, {"loss": 1.0}, self._result.n_samples, 0.0)


# ---------------------------------------------------------------------------
# EventBus + StragglerTracker primitives
# ---------------------------------------------------------------------------

def test_event_bus_dispatch_trace_and_unsubscribe():
    bus = EventBus()
    seen, everything = [], []
    unsub = bus.subscribe(RoundDispatched, seen.append)
    bus.subscribe(None, everything.append)
    e1 = bus.publish(RoundDispatched(0.0, 1, 4))
    e2 = bus.publish(RoundClosed(5.0, 1, 5.0))
    assert seen == [e1]                      # exact-type dispatch
    assert everything == [e1, e2]            # wildcard sees all
    assert bus.trace == [e1, e2]
    assert bus.events_of(RoundClosed) == [e2]
    unsub()
    bus.publish(RoundDispatched(6.0, 2, 4))
    assert len(seen) == 1
    bus.clear()
    assert bus.trace == []


def test_bus_mid_dispatch_unsubscribe_and_trace_cap():
    """A one-shot handler unsubscribing during dispatch must not skip
    its peers (snapshot dispatch), unsubscribe is idempotent, and
    max_events bounds the trace for long-lived buses."""
    bus = EventBus(max_events=4)
    order = []
    unsub_holder = []

    def one_shot(e):
        order.append("one_shot")
        unsub_holder[0]()
        unsub_holder[0]()  # idempotent: no ValueError

    unsub_holder.append(bus.subscribe(RoundClosed, one_shot))
    bus.subscribe(RoundClosed, lambda e: order.append("peer"))
    bus.publish(RoundClosed(1.0, 1, 1.0))
    bus.publish(RoundClosed(2.0, 2, 1.0))
    assert order == ["one_shot", "peer", "peer"]
    for i in range(30):
        bus.publish(RoundClosed(float(i), i, 1.0))
    assert 4 <= len(bus.trace) <= 7  # >= cap, < 2x cap (batched trim)
    assert bus.trace[-1].round_idx == 29
    # cap of 1 keeps exactly the newest event, never an empty trace
    tiny = EventBus(max_events=1)
    tiny.publish(RoundClosed(1.0, 1, 1.0))
    tiny.publish(RoundClosed(2.0, 2, 1.0))
    assert [e.round_idx for e in tiny.trace] == [2]
    with pytest.raises(ValueError):
        EventBus(max_events=0)


def test_null_bus_records_and_dispatches_nothing():
    bus = NullBus()
    hits = []
    bus.subscribe(None, hits.append)
    event = bus.publish(RoundDispatched(0.0, 1, 4))
    assert event.round_idx == 1              # publish still returns the event
    assert bus.trace == [] and hits == []


def test_straggler_tracker_escalates_and_resets():
    tracker = StragglerTracker(escalate_after=2)
    assert tracker.record_miss("c0") is None
    assert tracker.record_miss("c0") == 2    # threshold -> report + reset
    assert tracker.record_miss("c0") is None
    tracker.clear("c0")
    assert tracker.streak_of("c0") == 0
    with pytest.raises(ValueError):
        StragglerTracker(escalate_after=0)


# ---------------------------------------------------------------------------
# Protocol conformance: the four paper modules behind their APIs
# ---------------------------------------------------------------------------

def _toy_modules():
    env = make_toy_env()
    app = make_toy_app()
    cm = CostModel(env, app, 0.5)
    scheduler = DynamicScheduler(cm)
    ft = FaultToleranceModule(
        scheduler=scheduler, policy=CheckpointPolicy(), checkpoint_bytes=0
    )
    probe = CallableProbe(
        lambda vm: ProbeResult(1.0, 1.0), lambda a, b: ProbeResult(1.0, 1.0)
    )
    return (
        PreScheduling(env, probe),
        InitialMapping(env, app),
        ft,
        scheduler,
    )


def test_concrete_modules_conform_to_protocols():
    """The runtime half of the conformance pin (mypy --strict checks the
    static half via control_plane._static_conformance)."""
    pre, mapper, ft, scheduler = _toy_modules()
    assert isinstance(pre, PreSchedulerAPI)
    assert isinstance(mapper, MapperAPI)
    assert isinstance(ft, FaultToleranceAPI)
    assert isinstance(scheduler, SchedulerAPI)


def test_control_plane_rejects_non_conforming_modules():
    _, mapper, ft, scheduler = _toy_modules()

    class NotAScheduler:
        pass

    with pytest.raises(TypeError):
        ControlPlane(fault_tolerance=ft, scheduler=NotAScheduler())
    with pytest.raises(TypeError):
        ControlPlane(fault_tolerance=object(), scheduler=scheduler)
    cp = ControlPlane(fault_tolerance=ft, scheduler=scheduler, mapper=mapper)
    assert cp.solve_mapping().feasible
    with pytest.raises(RuntimeError):
        ControlPlane(fault_tolerance=ft, scheduler=scheduler).solve_mapping()


# ---------------------------------------------------------------------------
# Experiment builder: validation + adaptation
# ---------------------------------------------------------------------------

def test_builder_produces_validated_config(cloudlab_env):
    app = til_application(n_rounds=4)
    cfg = (Experiment.on(cloudlab_env).app(app)
           .markets(server="on_demand", clients="spot")
           .revocations(k_r=7200, seed=3, remove_revoked=False)
           .checkpoints(every=10)
           .rounds(4)
           .build())
    assert isinstance(cfg, SimulationConfig)
    assert cfg.server_market == "on_demand" and cfg.client_market == "spot"
    assert cfg.k_r == 7200 and cfg.seed == 3 and not cfg.remove_revoked
    assert cfg.checkpoint.server_interval_rounds == 10
    assert cfg.n_rounds == 4


def test_builder_chains_do_not_alias():
    base = Experiment.on(make_toy_env()).app(make_toy_app())
    spot = base.markets(clients="spot")
    assert base.build().client_market == "on_demand"
    assert spot.build().client_market == "spot"


def test_builder_rejects_incoherent_combinations(cloudlab_env):
    app = til_application()
    with pytest.raises(ValueError):  # deadline without async rounds
        Experiment.on(cloudlab_env).app(app).async_rounds(
            enabled=False, deadline=10.0
        )
    with pytest.raises(ValueError):  # quorum larger than the cohort (TIL: 4)
        (Experiment.on(cloudlab_env).app(app)
         .async_rounds(deadline=10.0, min_clients=9).build())
    # field-local rules are enforced once, in SimulationConfig.validate,
    # which build() runs via the shim
    with pytest.raises(ValueError):
        Experiment.on(cloudlab_env).app(app).markets(clients="preemptible").build()
    with pytest.raises(ValueError):
        Experiment.on(cloudlab_env).app(app).revocations(k_r=-1.0).build()
    with pytest.raises(ValueError):
        Experiment.on(cloudlab_env).app(app).async_rounds(
            deadline=10.0, escalate_after=0
        ).build()
    # coherence rules only the builder can see fail fast, in the setter
    with pytest.raises(ValueError):
        Experiment.on(cloudlab_env).app(app).checkpoints()  # policy XOR every
    with pytest.raises(ValueError):  # quorum without a deadline is a no-op
        Experiment.on(cloudlab_env).app(app).async_rounds(min_clients=2)
    with pytest.raises(ValueError):  # env/app are mandatory for build()
        Experiment().build()
    with pytest.raises(ValueError):
        Experiment.on(cloudlab_env).build()


def test_builder_adapts_round_deadline_policies(cloudlab_env):
    """One deadline spec drives both targets: a live-engine RoundDeadline
    given to the builder produces the same simulator result as the
    equivalent float T_round."""
    app = shakespeare_application(n_rounds=6)
    base = Experiment.on(cloudlab_env).app(app)
    via_policy = base.async_rounds(
        deadline=FixedDeadline(t_round_s=400.0, min_clients=2)
    ).simulate()
    via_float = base.async_rounds(deadline=400.0, min_clients=2).simulate()
    assert via_policy == via_float
    # ... and the policy's quorum is inherited when not overridden
    cfg = base.async_rounds(
        deadline=FixedDeadline(t_round_s=400.0, min_clients=3)
    ).build()
    assert cfg.deadline_min_clients == 3


def test_callable_deadline_adapts_sim_style_callable_to_live_engine():
    policy = CallableDeadline(fn=lambda r, offsets: max(offsets.values()) / 2)
    results = make_results(4)
    schedule = DeterministicSchedule({"c0": 1.0, "c1": 1.0, "c2": 1.0, "c3": 8.0})
    engine = AsyncRoundEngine(fold_cost_s=0.1, deadline=policy)
    report = engine.fold_round(1, results, schedule)
    assert report.policy_deadline_s == pytest.approx(4.0)
    assert report.carried_over == ["c3"]
    with pytest.raises(ValueError):
        CallableDeadline().deadline_s(1, {})


# ---------------------------------------------------------------------------
# Shim equivalence: Experiment.build() == legacy SimulationConfig
# ---------------------------------------------------------------------------

def _pr3_cut(round_idx, offsets):
    """The PR-3 benchmark deadline: just above the second-slowest arrival
    (the slowest silo misses every round)."""
    vals = sorted(offsets.values())
    return vals[-2] * 1.05


@pytest.mark.parametrize("k_r", [None, 3600])
def test_experiment_matches_legacy_simulation_config(cloudlab_env, k_r):
    """Acceptance pin: the builder and the legacy shim produce identical
    SimulationResults (events, trace, costs — the whole dataclass) for
    the PR-3 deadline-benchmark scenario, with and without revocations."""
    app = shakespeare_application(n_rounds=8)
    legacy_cfg = SimulationConfig(
        server_market="spot", client_market="spot", k_r=k_r, seed=3,
        remove_revoked=False, async_rounds=True, round_deadline=_pr3_cut,
        deadline_escalate_after=2,
        checkpoint=CheckpointPolicy(server_interval_rounds=4),
    )
    legacy = MultiCloudSimulator(cloudlab_env, app, legacy_cfg).run()
    built = (Experiment.on(cloudlab_env).app(app)
             .markets(server="spot", clients="spot")
             .revocations(k_r=k_r, seed=3, remove_revoked=False)
             .checkpoints(CheckpointPolicy(server_interval_rounds=4))
             .async_rounds(deadline=_pr3_cut, escalate_after=2)
             .simulate())
    assert legacy == built
    assert repr(legacy) == repr(built)
    assert legacy.trace  # the equality above compared real traces


# ---------------------------------------------------------------------------
# Trace determinism + event-stream invariants (simulator driver)
# ---------------------------------------------------------------------------

def _spot_deadline_experiment(env, app, seed=5):
    return (Experiment.on(env).app(app)
            .markets(server="spot", clients="spot")
            .revocations(k_r=200, seed=seed, remove_revoked=False)
            .checkpoints(every=5)
            .async_rounds(deadline=_pr3_cut, escalate_after=2))


def test_trace_is_deterministic_for_fixed_seed(cloudlab_env):
    app = shakespeare_application(n_rounds=10)
    exp = _spot_deadline_experiment(cloudlab_env, app)
    r1, r2 = exp.simulate(), exp.simulate()
    assert r1.trace == r2.trace
    assert any(isinstance(e, RevocationOccurred) for e in r1.trace)
    assert any(isinstance(e, DeadlineExpired) for e in r1.trace)
    assert any(isinstance(e, CheckpointSaved) for e in r1.trace)
    # a different seed produces a different timeline
    r3 = _spot_deadline_experiment(cloudlab_env, app, seed=6).simulate()
    assert r3.trace != r1.trace


def _rounds_from_trace(trace):
    """Split a trace into completed rounds (RoundClosed-delimited)."""
    rounds, current = [], []
    for event in trace:
        current.append(event)
        if isinstance(event, RoundClosed):
            rounds.append(current)
            current = []
    return rounds


def _check_arrival_fold_invariant(trace):
    """Every UpdateArrived is matched by exactly one fresh UpdateFolded
    or a carry-over entry in its round; carried-in messages fold stale."""
    rounds = _rounds_from_trace(trace)
    assert rounds
    for chunk in rounds:
        closed = chunk[-1]
        arrived = [e.task for e in chunk if isinstance(e, UpdateArrived)]
        fresh = [e.task for e in chunk
                 if isinstance(e, UpdateFolded) and not e.stale]
        stale = [e.task for e in chunk
                 if isinstance(e, UpdateFolded) and e.stale]
        assert len(arrived) == len(set(arrived))  # one arrival per silo
        assert sorted(arrived) == sorted(fresh + list(closed.carried_over))
        assert sorted(stale) == sorted(closed.carried_in)
    return rounds


def test_simulator_trace_satisfies_arrival_fold_invariant(cloudlab_env):
    app = shakespeare_application(n_rounds=10)
    res = _spot_deadline_experiment(cloudlab_env, app).simulate()
    rounds = _check_arrival_fold_invariant(res.trace)
    assert len(rounds) >= 10  # rewound rounds re-close
    # carry-over really flows: some round drains a stale fold
    assert any(chunk[-1].carried_in for chunk in rounds)
    # escalations in the result are exactly the bus's view
    assert res.escalations == [e for e in res.trace
                               if isinstance(e, StragglerEscalated)]
    assert res.events == [e for e in res.trace
                          if isinstance(e, RevocationOccurred)]


# ---------------------------------------------------------------------------
# Event-stream invariants (live engine driver) — PR-3 conservation,
# restated over the bus instead of FoldReport internals
# ---------------------------------------------------------------------------

def test_engine_event_stream_conserves_weight_and_pairs_arrivals():
    results = make_results(4)
    schedule = DeterministicSchedule({"c0": 1.0, "c1": 1.0, "c2": 1.0, "c3": 5.0})
    bus = EventBus()
    engine = AsyncRoundEngine(
        fold_cost_s=0.1, deadline=FixedDeadline(t_round_s=2.0),
        carry_discount=0.5, bus=bus,
    )
    n_rounds = 3
    for r in range(1, n_rounds + 1):
        engine.fold_round(r, results, schedule)
    rounds = _check_arrival_fold_invariant(bus.trace)
    assert len(rounds) == n_rounds
    # weight conservation over the event stream: raw folded weight plus
    # still-parked weight == per-silo weight x rounds
    folded = sum(e.weight for e in bus.trace if isinstance(e, UpdateFolded))
    total = sum(r.n_samples for r in results)
    assert folded + engine.carry.pending_weight() == pytest.approx(
        n_rounds * total
    )
    # the straggler's stale folds carry their discount in the events
    stale = [e for e in bus.trace if isinstance(e, UpdateFolded) and e.stale]
    assert stale and all(e.folded_weight == pytest.approx(0.5 * e.weight)
                         for e in stale)


def test_async_server_escalation_flows_through_the_bus():
    """AsyncFLServer consumes the control-plane bus: §4.4 escalations
    reach on_straggler via a StragglerEscalated subscription, and a
    second direct subscriber sees the same event."""
    results = make_results(3)
    hook_calls, direct = [], []
    server = AsyncFLServer(
        [StubClient(r) for r in results], results[0].params, device="cpu",
        schedule=DeterministicSchedule({"c0": 1.0, "c1": 1.0, "c2": 9.0}),
        fold_cost_s=0.1, round_deadline=FixedDeadline(t_round_s=2.0),
        escalate_after=2,
        on_straggler=lambda cid, r: hook_calls.append((cid, r)),
    )
    server.bus.subscribe(StragglerEscalated, direct.append)
    server.run(3)
    assert hook_calls == [("c2", 2)]
    assert len(direct) == 1 and direct[0].task == "c2"
    assert direct[0].consecutive_misses == 2
    # fold-level events landed on the same bus
    assert server.bus.events_of(DeadlineExpired)
    assert server.bus.events_of(UpdateArrived)


def test_null_bus_disables_tracing_but_not_escalation():
    """NULL_BUS drops the trace, but §4.4 recovery must still reach the
    on_straggler hook (tracing is observability, not orchestration)."""
    from repro_torch.core.events import NULL_BUS

    results = make_results(3)
    hook_calls = []
    server = AsyncFLServer(
        [StubClient(r) for r in results], results[0].params, device="cpu",
        schedule=DeterministicSchedule({"c0": 1.0, "c1": 1.0, "c2": 9.0}),
        fold_cost_s=0.1, round_deadline=FixedDeadline(t_round_s=2.0),
        escalate_after=2,
        on_straggler=lambda cid, r: hook_calls.append((cid, r)),
        bus=NULL_BUS,
    )
    server.run(3)
    assert hook_calls == [("c2", 2)]
    assert server.bus.trace == []


def test_serve_min_clients_override_beats_policy_quorum():
    """One chain, one quorum: an explicit .async_rounds(min_clients=...)
    override wins over the RoundDeadline policy's own quorum on BOTH
    targets (build() and serve())."""
    results = make_results(4)
    exp = Experiment().async_rounds(
        deadline=FixedDeadline(t_round_s=2.0, min_clients=2), min_clients=4
    )
    server = exp.serve([StubClient(r) for r in results], results[0].params, device="cpu",
                       schedule=DeterministicSchedule(
                           {"c0": 1.0, "c1": 1.0, "c2": 1.0, "c3": 5.0}),
                       fold_cost_s=0.1)
    assert server._round_engine.deadline.min_clients == 4
    run = server.run(1)
    assert run.rounds[0].carried_over == []  # quorum 4 waits for c3


def test_live_recovery_event_uses_documented_vocabulary(tmp_path):
    """RecoveryCompleted from the live server speaks the same
    restored_from vocabulary as the simulator (client_local:<cid>) and
    reports the round the loop re-executes."""
    from repro_torch.checkpoint import ClientCheckpointManager
    from repro_torch.core import RecoveryCompleted

    results = make_results(2)
    mgr = ClientCheckpointManager(str(tmp_path / "c0"))
    server = AsyncFLServer(
        [StubClient(r) for r in results], results[0].params, device="cpu",
        client_ckpts={"c0": mgr},
        fault_hook=lambda r: "s" if r == 2 else None,
    )
    server.run(2)
    recoveries = server.bus.events_of(RecoveryCompleted)
    assert len(recoveries) == 1
    assert recoveries[0].restored_from == "client_local:c0"
    assert recoveries[0].resume_round == 2


def test_serve_rejects_simulator_only_chain_settings():
    """serve() refuses chains carrying settings only the simulator can
    honor (checkpoint policies, revocation models, markets) instead of
    silently dropping them."""
    results = make_results(2)
    clients = [StubClient(r) for r in results]
    chain = (Experiment.on(make_toy_env()).app(make_toy_app())
             .checkpoints(every=5).revocations(k_r=3600))
    with pytest.raises(ValueError, match="simulator"):
        chain.serve(clients, results[0].params, device="cpu")
    with pytest.raises(ValueError, match="simulator"):
        Experiment().markets(clients="spot").serve(clients, results[0].params,
                                                   device="cpu")
    # ... while the same chain still simulates, and an async-only chain
    # still serves.
    assert chain.rounds(2).simulate().rounds_completed == 2
    assert Experiment().async_rounds().serve(clients, results[0].params, device="cpu")


def test_build_rejects_weight_quorum_the_simulator_cannot_honor(cloudlab_env):
    """A RoundDeadline with min_weight_frac cannot run on the simulator
    (no per-silo example weights there) — build() refuses rather than
    silently diverging from serve()."""
    app = til_application()
    chain = Experiment.on(cloudlab_env).app(app).async_rounds(
        deadline=FixedDeadline(t_round_s=10.0, min_weight_frac=0.5)
    )
    with pytest.raises(ValueError, match="min_weight_frac"):
        chain.build()
    # the live target honors it
    results = make_results(2)
    server = (Experiment()
              .async_rounds(deadline=FixedDeadline(t_round_s=10.0,
                                                   min_weight_frac=0.5))
              .serve([StubClient(r) for r in results], results[0].params,
                     device="cpu"))
    assert server._round_engine.deadline.min_weight_frac == 0.5


def test_on_straggler_fires_after_fold_report_is_visible():
    """PR-3 contract: the escalation hook runs after the round's
    FoldReport lands in fold_reports (hooks may inspect fold_reports[-1],
    including an escalate_after=1 escalation in round 1)."""
    results = make_results(3)
    seen = []

    server_holder = []

    def hook(cid, round_idx):
        server = server_holder[0]
        assert server.fold_reports  # never fires before the append
        seen.append((cid, round_idx, server.fold_reports[-1].escalations))

    server = AsyncFLServer(
        [StubClient(r) for r in results], results[0].params, device="cpu",
        schedule=DeterministicSchedule({"c0": 1.0, "c1": 1.0, "c2": 9.0}),
        fold_cost_s=0.1, round_deadline=FixedDeadline(t_round_s=2.0),
        escalate_after=1, on_straggler=hook,
    )
    server_holder.append(server)
    server.run(2)
    assert seen == [("c2", 1, ["c2"]), ("c2", 2, ["c2"])]


def test_escalation_recovery_event_reports_checkpoint_source(cloudlab_env):
    """ControlPlane.escalate's RecoveryCompleted carries the client's
    checkpoint location when the FT module recorded one (it used to be
    hardcoded to 'none')."""
    from repro_torch.core import RecoveryCompleted, StragglerEscalated as SE

    app = shakespeare_application(n_rounds=4)
    res = (Experiment.on(cloudlab_env).app(app)
           .checkpoints(every=2)
           .async_rounds(deadline=_pr3_cut, escalate_after=2)
           .simulate())
    escalated = {e.task for e in res.trace if isinstance(e, SE)}
    assert escalated  # the cut deadline forces an escalation
    recoveries = [e for e in res.trace if isinstance(e, RecoveryCompleted)
                  and e.task in escalated]
    assert recoveries
    assert all(r.restored_from.startswith("client_local:")
               for r in recoveries)


def test_experiment_serve_matches_manual_async_server():
    """The builder's live target: Experiment.serve() behaves exactly like
    a hand-built AsyncFLServer with the same deadline policy."""
    results = make_results(4)
    schedule = DeterministicSchedule({"c0": 1.0, "c1": 1.0, "c2": 1.0, "c3": 5.0})
    manual = AsyncFLServer(
        [StubClient(r) for r in results], results[0].params, device="cpu",
        schedule=schedule, fold_cost_s=0.1,
        round_deadline=FixedDeadline(t_round_s=2.0, min_clients=3),
        carry_discount=0.5,
    )
    built = (Experiment()
             .async_rounds(deadline=2.0, min_clients=3, carry_discount=0.5)
             .serve([StubClient(r) for r in results], results[0].params, device="cpu",
                    schedule=schedule, fold_cost_s=0.1))
    run_manual, run_built = manual.run(2), built.run(2)
    assert [r.carried_over for r in run_manual.rounds] == \
        [r.carried_over for r in run_built.rounds]
    assert [r.carried_in for r in run_manual.rounds] == \
        [r.carried_in for r in run_built.rounds]
    for a, b in zip(tree_leaves(run_manual.final_params),
                    tree_leaves(run_built.final_params)):
        np.testing.assert_allclose(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# trace_dump script
# ---------------------------------------------------------------------------

def test_trace_dump_formats_a_real_trace(cloudlab_env):
    import trace_dump

    app = til_application(n_rounds=3)
    res = (Experiment.on(cloudlab_env).app(app)
           .async_rounds(deadline=1e6).simulate())
    text = trace_dump.format_trace(res.trace)
    assert "RoundDispatched" in text and "RoundClosed" in text
    assert "UpdateFolded" in text
    limited = trace_dump.format_trace(res.trace, limit=3)
    assert "more events" in limited
    payload = trace_dump.trace_to_json(res.trace)
    assert payload[0]["event"] == "RoundDispatched"
    assert all("time_s" in row for row in payload)
