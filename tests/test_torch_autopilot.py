"""The port's cost autopilot: the reference's tests/test_autopilot.py run
on ``repro_torch.core``, its live-target tests on the port's servers
with tensors on the CPU.

Cost autopilot tests: price feeds, budget-constrained policies,
risk-aware checkpoint cadence, and the adaptive deadline controller —
plus the satellite regressions (market-aware §4.4 replacement ranking
and the Eq.-7 cost_max cache under measured compressed wire bytes)."""
import json
import math

import pytest
import torch

from test_torch_control_plane import StubClient
from test_torch_core_models import port_toy_app as make_toy_app
from test_torch_core_models import port_toy_env as make_toy_env
from repro_torch.core import (
    SERVER,
    Assignment,
    AutopilotSpec,
    BudgetTracker,
    BudgetedMapper,
    CheckpointPolicy,
    CostAwareScheduler,
    CostModel,
    DeadlineController,
    DynamicScheduler,
    EventBus,
    Experiment,
    InitialMapping,
    MultiCloudSimulator,
    PriceTicker,
    RiskAwareCheckpointPolicy,
    SimulationConfig,
    SyntheticSpotFeed,
    TracePriceFeed,
    cloudlab_environment,
    til_application,
)
from repro_torch.core.cloud_model import PricePoint, SpotPriceTrace
from repro_torch.core.events import (
    BudgetExceeded,
    CheckpointSaved,
    CostAccrued,
    DeadlineAdjusted,
    DeadlineExpired,
    PriceUpdated,
    RevocationOccurred,
    RoundDispatched,
    UpdateArrived,
)


# ---------------------------------------------------------------------------
# Price feeds (SpotPriceTrace / SyntheticSpotFeed / TracePriceFeed)
# ---------------------------------------------------------------------------

def test_synthetic_feed_is_deterministic_and_order_independent():
    env = cloudlab_environment()
    vm = next(iter(env.vm_types.values()))
    a = SyntheticSpotFeed(seed=7)
    b = SyntheticSpotFeed(seed=7)
    # Query b at later times first: per-(seed, vm) walks must not depend
    # on query order.
    later = [b.spot_price_per_hour(vm, t) for t in (9000.0, 600.0, 0.0)]
    early = [a.spot_price_per_hour(vm, t) for t in (0.0, 600.0, 9000.0)]
    assert early == list(reversed(later))
    assert SyntheticSpotFeed(seed=8).spot_price_per_hour(vm, 9000.0) != later[0]


def test_synthetic_feed_prices_stay_in_band():
    env = cloudlab_environment()
    feed = SyntheticSpotFeed(seed=3, floor_mult=0.4, cap_mult=2.5)
    for vm in env.vm_types.values():
        for t in range(0, 40000, 1500):
            p = feed.spot_price_per_hour(vm, float(t))
            assert 0.4 * vm.cost_spot_hour - 1e-12 <= p <= 2.5 * vm.cost_spot_hour + 1e-12


def test_trace_export_replays_identically():
    env = cloudlab_environment()
    vms = list(env.vm_types.values())[:3]
    feed = SyntheticSpotFeed(seed=5, step_s=300.0)
    trace = feed.trace(vms, until_s=3000.0)
    replay = TracePriceFeed(trace)
    for vm in vms:
        for t in (0.0, 299.0, 300.0, 1501.0, 2999.0):
            assert replay.spot_price_per_hour(vm, t) == pytest.approx(
                feed.spot_price_per_hour(vm, t)
            )


def test_trace_json_roundtrip():
    trace = SpotPriceTrace(points=(
        PricePoint(0.0, "vm_a", 1.0),
        PricePoint(600.0, "vm_a", 1.5),
        PricePoint(0.0, "vm_b", 0.2),
    ))
    again = SpotPriceTrace.from_json(trace.to_json())
    assert again == trace
    with pytest.raises(ValueError):
        SpotPriceTrace(points=(PricePoint(0.0, "vm_a", -1.0),))
    with pytest.raises(ValueError):  # per-vm time order enforced
        SpotPriceTrace(points=(
            PricePoint(600.0, "vm_a", 1.0), PricePoint(0.0, "vm_a", 1.0),
        ))


def test_cost_between_integrates_the_walk():
    env = make_toy_env(n_vms=2)
    vm = env.vm_types["vm0"]
    trace = SpotPriceTrace(points=(
        PricePoint(0.0, "vm0", 3600.0),     # $1/s for the first 100s
        PricePoint(100.0, "vm0", 7200.0),   # then $2/s
    ))
    feed = TracePriceFeed(trace)
    assert feed.cost_between(vm, "spot", 50.0, 150.0) == pytest.approx(
        50.0 * 1.0 + 50.0 * 2.0
    )
    # on_demand ignores the walk entirely.
    od = vm.cost_per_second("on_demand")
    assert feed.cost_between(vm, "on_demand", 50.0, 150.0) == pytest.approx(100.0 * od)


def test_cost_model_price_hooks_fall_back_to_static():
    env = make_toy_env(n_vms=2)
    app = make_toy_app()
    cm = CostModel(env, app, 0.5)
    vm = env.vm_types["vm1"]
    assert cm.price_per_second("vm1", "spot", 123.0) == vm.cost_per_second("spot")
    assert cm.vm_cost_between("vm1", "spot", 0.0, 10.0) == pytest.approx(
        10.0 * vm.cost_per_second("spot")
    )


def test_price_ticker_publishes_only_on_change():
    env = make_toy_env(n_vms=1)
    vm = env.vm_types["vm0"]
    trace = SpotPriceTrace(points=(
        PricePoint(0.0, "vm0", vm.cost_spot_hour * 2.0),
        PricePoint(600.0, "vm0", vm.cost_spot_hour * 2.0),   # unchanged
        PricePoint(1200.0, "vm0", vm.cost_spot_hour * 0.5),
    ))
    ticker = PriceTicker(TracePriceFeed(trace))
    bus = EventBus()
    first = ticker.publish_updates(bus, [vm], 0.0, round_idx=1)
    assert len(first) == 1  # first quote differs from the listed price
    assert first[0].prev_per_hour == vm.cost_spot_hour
    assert ticker.publish_updates(bus, [vm], 600.0, round_idx=2) == []
    third = ticker.publish_updates(bus, [vm], 1200.0, round_idx=3)
    assert len(third) == 1 and third[0].price_per_hour == vm.cost_spot_hour * 0.5
    assert len(bus.events_of(PriceUpdated)) == 2


# ---------------------------------------------------------------------------
# BudgetTracker
# ---------------------------------------------------------------------------

def test_budget_tracker_pressure_and_single_exceeded_event():
    bus = EventBus()
    tracker = BudgetTracker(10.0)
    tracker.attach(bus)
    bus.publish(CostAccrued(1.0, "vm", 4.0, round_idx=1))
    assert tracker.pressure() == pytest.approx(0.4)
    assert tracker.remaining_usd() == pytest.approx(6.0)
    bus.publish(CostAccrued(2.0, "comm", 7.0, round_idx=2))
    bus.publish(CostAccrued(3.0, "vm", 5.0, round_idx=3))
    exceeded = bus.events_of(BudgetExceeded)
    assert len(exceeded) == 1
    assert exceeded[0].source == "tracker"
    assert exceeded[0].spent == pytest.approx(11.0)
    assert tracker.pressure() == 1.0  # clamped


# ---------------------------------------------------------------------------
# DeadlineController
# ---------------------------------------------------------------------------

def _drive_round(bus, r, dispatch_t, offsets, late=(), close_t=None):
    bus.publish(RoundDispatched(dispatch_t, r, len(offsets)))
    for cid, off in sorted(offsets.items()):
        bus.publish(UpdateArrived(dispatch_t + off, r, cid))
    close = close_t if close_t is not None else dispatch_t + max(offsets.values())
    on_time = tuple(c for c in offsets if c not in set(late))
    bus.publish(DeadlineExpired(close, r, close, close, on_time, tuple(late)))


def test_controller_bootstraps_from_first_offsets():
    ctl = DeadlineController(target_quantile=1.0, slack=1.2)
    t = ctl.propose(1, {"a": 5.0, "b": 10.0})
    assert t == pytest.approx(12.0)
    # Stable until evidence arrives.
    assert ctl.propose(2, {"a": 50.0}) == pytest.approx(12.0)


def test_controller_walks_toward_arrival_quantile():
    bus = EventBus()
    ctl = DeadlineController(
        initial_t_round_s=100.0, target_quantile=1.0, slack=1.2,
        max_step_frac=0.25, ema=1.0,
    )
    ctl.attach(bus)
    now = 0.0
    for r in range(1, 9):
        _drive_round(bus, r, now, {"a": 8.0, "b": 10.0})
        now += 100.0
    # Arrivals peak at 10s -> target 12s; each round moves at most 25%.
    assert ctl.t_round_s == pytest.approx(12.0, rel=0.05)
    adjustments = bus.events_of(DeadlineAdjusted)
    assert adjustments, "retuning must be visible on the bus"
    for e in adjustments:
        assert e.new_t_round_s >= 0.75 * e.old_t_round_s - 1e-9
        assert e.reason in ("arrivals", "carry", "cost")
    assert ctl.adjustments == adjustments


def test_controller_carry_pressure_extends_deadline():
    def final_t(late):
        bus = EventBus()
        ctl = DeadlineController(initial_t_round_s=12.0, target_quantile=1.0,
                                 slack=1.2, ema=1.0, carry_gain=1.0)
        ctl.attach(bus)
        for r in range(1, 6):
            _drive_round(bus, r, r * 100.0, {"a": 8.0, "b": 10.0}, late=late)
        return ctl.t_round_s

    assert final_t(late=("b",)) > final_t(late=())


def test_controller_hot_prices_tighten_deadline():
    def final_t(heat):
        bus = EventBus()
        ctl = DeadlineController(initial_t_round_s=12.0, target_quantile=1.0,
                                 slack=1.2, ema=1.0, cost_gain=1.0)
        ctl.attach(bus)
        for r in range(1, 6):
            if heat:
                bus.publish(PriceUpdated(r * 100.0, "vm0", 2.0, 1.0, 1.0, r))
            _drive_round(bus, r, r * 100.0, {"a": 8.0, "b": 10.0})
        return ctl.t_round_s

    hot, calm = final_t(True), final_t(False)
    assert hot < calm
    assert calm == pytest.approx(12.0)


def test_controller_cost_overrun_tightens_deadline():
    def final_t(allowance):
        bus = EventBus()
        ctl = DeadlineController(initial_t_round_s=12.0, target_quantile=1.0,
                                 slack=1.2, ema=1.0, cost_gain=1.0,
                                 round_cost_allowance_usd=allowance)
        ctl.attach(bus)
        for r in range(1, 6):
            _drive_round(bus, r, r * 100.0, {"a": 8.0, "b": 10.0})
            bus.publish(CostAccrued(r * 100.0 + 50.0, "vm", 2.0, round_idx=r))
        return ctl.t_round_s

    assert final_t(allowance=1.0) < final_t(allowance=None)


def test_controller_respects_clamps():
    bus = EventBus()
    ctl = DeadlineController(initial_t_round_s=20.0, target_quantile=1.0,
                             slack=1.2, ema=1.0, min_t_round_s=18.0)
    ctl.attach(bus)
    for r in range(1, 8):
        _drive_round(bus, r, r * 100.0, {"a": 1.0})
    assert ctl.t_round_s == pytest.approx(18.0)


# ---------------------------------------------------------------------------
# BudgetedMapper
# ---------------------------------------------------------------------------

def _toy_mapper_parts(spot_frac=0.3):
    env = make_toy_env(n_vms=3)
    app = make_toy_app(n_clients=2)
    cm = CostModel(env, app, 0.5)
    inner = InitialMapping(env, app, alpha=0.5)
    return env, app, cm, inner


def test_budgeted_mapper_prefers_spot_when_revocations_rare():
    env, app, cm, inner = _toy_mapper_parts()
    mapper = BudgetedMapper(inner, cm, n_rounds=5, k_r=1e9)
    sol = mapper.solve()
    assert sol.placement[SERVER].market == "on_demand"  # paper rule
    for c in app.clients:
        # Toy env spot = 30% of on-demand and revocations are ~never.
        assert sol.placement[c.client_id].market == "spot"
    assert mapper.projected_run_cost_usd is not None


def test_budgeted_mapper_falls_back_on_demand_when_revocations_bite():
    env, app, cm, inner = _toy_mapper_parts()
    # Expected revocation cost dominates: k_r far below the makespan and
    # a brutal restart penalty make every spot round pay the replacement
    # spin-up almost surely.
    makespan = inner.solve().evaluation.makespan_s
    mapper = BudgetedMapper(
        inner, cm, n_rounds=5, k_r=makespan / 50.0,
        vm_startup_s=makespan * 10.0,
    )
    sol = mapper.solve()
    for c in app.clients:
        assert sol.placement[c.client_id].market == "on_demand"


def test_budgeted_mapper_publishes_budget_exceeded_but_still_places():
    env, app, cm, inner = _toy_mapper_parts()
    bus = EventBus()
    mapper = BudgetedMapper(inner, cm, budget_usd=1e-9, n_rounds=10,
                            k_r=None, bus=bus)
    sol = mapper.solve()
    assert sol.placement  # graceful: cheapest placement still returned
    events = bus.events_of(BudgetExceeded)
    assert len(events) == 1 and events[0].source == "mapper"
    assert events[0].spent == pytest.approx(mapper.projected_run_cost_usd)


# ---------------------------------------------------------------------------
# Satellite: market-aware select_instance regressions
# ---------------------------------------------------------------------------

class _Pressure:
    def __init__(self, p):
        self._p = p

    def pressure(self):
        return self._p


def _scheduler_fixture():
    env = make_toy_env(n_vms=3)
    app = make_toy_app(n_clients=2)
    cm = CostModel(env, app, 0.5)
    current = {
        SERVER: Assignment("vm0", "on_demand"),
        "c0": Assignment("vm1", "on_demand"),
        "c1": Assignment("vm2", "on_demand"),
    }
    return env, app, cm, current


def test_default_replacement_keeps_market():
    env, app, cm, current = _scheduler_fixture()
    sched = DynamicScheduler(cm)
    assert not sched.market_aware
    d = sched.select_instance("c0", current, "vm1", remove_revoked=False)
    assert d.market == "on_demand"


def test_cheaper_spot_replacement_wins_under_budget_pressure():
    env, app, cm, current = _scheduler_fixture()
    sched = DynamicScheduler(cm)
    sched.budget = _Pressure(0.95)  # nearly drained: alpha_eff -> 1
    assert sched.market_aware
    d = sched.select_instance("c0", current, "vm1", remove_revoked=False)
    # Toy spot prices are 30% of on-demand with identical makespans, so
    # under budget pressure the spot candidate must win the objective.
    assert d.market == "spot"


def test_repeated_spot_revocations_force_on_demand_fallback():
    env, app, cm, current = _scheduler_fixture()
    sched = DynamicScheduler(cm, spot_fallback_after=2)
    sched.budget = _Pressure(0.95)
    spot_map = dict(current)
    spot_map["c0"] = Assignment("vm1", "spot")
    # Two spot revocations inside the cooldown window...
    d1 = sched.select_instance("c0", spot_map, "vm1", now_s=0.0)
    spot_map["c0"] = Assignment(d1.new_vm, "spot")
    d2 = sched.select_instance("c0", spot_map, d1.new_vm, now_s=100.0)
    assert sched.spot_revocations_in_window("c0", 200.0) == 2
    spot_map["c0"] = Assignment(d2.new_vm, "spot")
    # ...and the third replacement refuses spot despite the price edge.
    d3 = sched.select_instance("c0", spot_map, d2.new_vm, now_s=200.0)
    assert d3.market == "on_demand"
    # Once the history decays the spot market is offered again.
    decayed = sched.spot_revocations_in_window("c0", 100.0 + 3600.0 + 1.0)
    assert decayed < 2


def test_cost_aware_scheduler_is_always_market_aware():
    env, app, cm, current = _scheduler_fixture()
    sched = CostAwareScheduler(cm)
    assert sched.market_aware
    d = sched.select_instance("c0", current, "vm1", remove_revoked=False)
    assert d.market in ("spot", "on_demand")


def test_feed_prices_steer_replacement_choice():
    env, app, cm, current = _scheduler_fixture()
    vm = env.vm_types["vm0"]
    # vm0's spot quote spikes 100x while vm2's stays listed: at now_s the
    # market-aware ranking must not pick vm0/spot.
    spike = SpotPriceTrace(points=(
        PricePoint(0.0, "vm0", vm.cost_spot_hour * 100.0),
    ))
    feed = TracePriceFeed(spike)
    cm_feed = CostModel(env, app, 0.5, price_feed=feed)
    sched = DynamicScheduler(cm_feed, price_feed=feed)
    d = sched.select_instance("c0", current, "vm1", remove_revoked=False,
                              now_s=0.0)
    assert not (d.new_vm == "vm0" and d.market == "spot")


# ---------------------------------------------------------------------------
# RiskAwareCheckpointPolicy
# ---------------------------------------------------------------------------

def test_risk_cadence_tightens_with_clustered_revocations():
    policy = RiskAwareCheckpointPolicy(server_interval_rounds=10)
    assert policy.current_interval_rounds() == 10  # calm baseline
    for r in (3, 6, 9):
        policy.observe_revocation(r)
    assert policy.current_interval_rounds() <= 2  # ~gap/2, clamped >= 1


def test_risk_cadence_tightens_when_spot_runs_hot():
    calm = RiskAwareCheckpointPolicy(server_interval_rounds=10,
                                     price_sensitivity=2.0)
    hot = RiskAwareCheckpointPolicy(server_interval_rounds=10,
                                    price_sensitivity=2.0)
    for p in (calm, hot):
        p.observe_revocation(8)  # same revocation evidence
    hot.observe_price(2.0)  # quotes at 2x listed
    assert hot.current_interval_rounds() <= calm.current_interval_rounds()
    assert hot.current_interval_rounds() >= 1


def test_risk_policy_attaches_to_bus():
    bus = EventBus()
    policy = RiskAwareCheckpointPolicy(server_interval_rounds=8)
    unsubscribe = policy.attach(bus)
    bus.publish(RevocationOccurred(100.0, "c0", "vm0", "vm1", round_idx=4))
    bus.publish(PriceUpdated(110.0, "vm0", 2.0, 1.0, 1.0, 4))
    assert policy.current_interval_rounds() < 8
    unsubscribe()
    before = policy.current_interval_rounds()
    bus.publish(RevocationOccurred(200.0, "c0", "vm0", "vm1", round_idx=5))
    assert policy.current_interval_rounds() == before


def test_risk_policy_checkpoints_at_current_cadence():
    policy = RiskAwareCheckpointPolicy(server_interval_rounds=4)
    fired = [r for r in range(1, 13) if policy.server_checkpoints_at(r)]
    assert fired == [4, 8, 12]
    tight = RiskAwareCheckpointPolicy(server_interval_rounds=4)
    for r in (1, 2, 3):
        tight.observe_revocation(r)
    fired = [r for r in range(1, 7) if tight.server_checkpoints_at(r)]
    assert len(fired) >= 4  # every-round-ish under clustered revocations


# ---------------------------------------------------------------------------
# Satellite: Eq.-7 cost_max cache vs measured compressed wire bytes
# ---------------------------------------------------------------------------

def test_update_message_sizes_invalidates_cost_max_cache():
    from repro_torch.federated.messages import measure_messages, to_cost_model_sizes

    env = cloudlab_environment()
    app = til_application()
    cm = CostModel(env, app, 0.5)
    dense_cost_max = cm.cost_max()  # prime the Eq.-7 cache
    dense_comm = cm.comm_cost("cloud_a", "cloud_b")

    params = {"w": torch.zeros(250_000)}  # ~1 MB dense
    log = measure_messages(params, {"loss": 1.0}, compression="int8")
    assert log.c_msg_train_bytes < log.s_msg_train_bytes  # compressed leg
    cm.update_message_sizes(to_cost_model_sizes(log))

    # The cache was invalidated, not served stale: both Eq.-6 and Eq.-7
    # now reflect the measured (compressed) wire bytes.
    assert cm.comm_cost("cloud_a", "cloud_b") != pytest.approx(dense_comm)
    fresh = CostModel(env, cm.app, 0.5)
    assert cm.cost_max() == pytest.approx(fresh.cost_max())
    assert cm.cost_max() != pytest.approx(dense_cost_max)
    # t_max has no per-GB term and must be untouched.
    assert cm.t_max() == pytest.approx(fresh.t_max())


def test_update_message_sizes_cache_roundtrip_is_stable():
    env = make_toy_env(n_vms=2)
    app = make_toy_app()
    cm = CostModel(env, app, 0.5)
    original = cm.cost_max()
    sizes = app.messages
    smaller = type(sizes)(
        s_msg_train_gb=sizes.s_msg_train_gb,
        s_msg_aggreg_gb=sizes.s_msg_aggreg_gb,
        c_msg_train_gb=sizes.c_msg_train_gb * 0.25,
        c_msg_test_gb=sizes.c_msg_test_gb,
    )
    cm.update_message_sizes(smaller)
    shrunk = cm.cost_max()
    cm.update_message_sizes(sizes)
    assert cm.cost_max() == pytest.approx(original)
    assert shrunk < original


# ---------------------------------------------------------------------------
# AutopilotSpec / builder validation
# ---------------------------------------------------------------------------

def test_autopilot_spec_rejects_all_features_off():
    with pytest.raises(ValueError, match="every feature off"):
        AutopilotSpec()


def test_autopilot_spec_validates_knobs():
    with pytest.raises(ValueError):
        AutopilotSpec(budget_usd=-1.0)
    with pytest.raises(ValueError):
        AutopilotSpec(adaptive_deadline=True, deadline_slack=0.5)
    with pytest.raises(ValueError):
        AutopilotSpec(adaptive_deadline=True, min_t_round_s=10.0,
                      max_t_round_s=5.0)
    with pytest.raises(ValueError):
        AutopilotSpec(budget_usd=1.0, spot_fallback_after=0)


def test_builder_rejects_adaptive_deadline_without_async_rounds():
    env = cloudlab_environment()
    app = til_application()
    with pytest.raises(ValueError, match="async_rounds"):
        (Experiment.on(env).app(app)
         .autopilot(adaptive_deadline=True).build())


def test_builder_rejects_risk_checkpointing_without_policy():
    env = cloudlab_environment()
    app = til_application()
    with pytest.raises(ValueError, match="checkpoint"):
        (Experiment.on(env).app(app)
         .autopilot(budget=1.0, risk_checkpointing=True).build())


def test_serve_rejects_simulator_only_autopilot_features():
    app_params = torch.zeros(2)
    clients = [StubClient.from_params("c0", app_params, 1)]
    chain = Experiment().autopilot(price_feed=SyntheticSpotFeed())
    with pytest.raises(ValueError, match="simulator-target"):
        chain.serve(clients, app_params, device="cpu")


def test_serve_rejects_deadline_conflicts():
    app_params = torch.zeros(2)
    clients = [StubClient.from_params("c0", app_params, 1)]
    chain = Experiment().autopilot(adaptive_deadline=True)
    with pytest.raises(ValueError, match="both claim T_round"):
        chain.serve(clients, app_params, round_deadline=None, device="cpu")
    chain2 = (Experiment()
              .async_rounds(deadline=lambda r, offs: 5.0)
              .autopilot(adaptive_deadline=True))
    with pytest.raises(ValueError, match="replaces the chain's deadline"):
        chain2.serve(clients, app_params, device="cpu")


# ---------------------------------------------------------------------------
# End-to-end: simulator target
# ---------------------------------------------------------------------------

def _base_chain(env, app, seed=3):
    return (Experiment.on(env).app(app)
            .markets(clients="spot")
            .revocations(k_r=7200, seed=seed)
            .checkpoints(every=4)
            .async_rounds(deadline=app.t_round))


def test_simulator_autopilot_emits_new_event_vocabulary():
    env = cloudlab_environment()
    app = til_application(n_rounds=8)
    feed = SyntheticSpotFeed(seed=11)
    res = (_base_chain(env, app)
           .autopilot(budget=5.0, price_feed=feed, adaptive_deadline=True,
                      risk_checkpointing=True)
           .simulate())
    kinds = {type(e).__name__ for e in res.trace}
    assert {"PriceUpdated", "DeadlineAdjusted"} <= kinds
    adjusted = [e for e in res.trace if isinstance(e, DeadlineAdjusted)]
    assert all(e.new_t_round_s > 0 for e in adjusted)
    # Per-round billing: vm CostAccrued events land during the run, not
    # as one end-of-run lump sum.
    vm_accruals = [e for e in res.trace
                   if isinstance(e, CostAccrued) and e.kind == "vm"]
    assert len(vm_accruals) > 1
    assert sum(e.amount for e in vm_accruals) == pytest.approx(res.vm_cost)


def test_simulator_budget_tracker_matches_result_cost():
    env = cloudlab_environment()
    app = til_application(n_rounds=8)
    cfg = _base_chain(env, app).autopilot(budget=50.0).build()
    sim = MultiCloudSimulator(env, app, cfg)
    res = sim.run()
    assert sim.budget_tracker is not None
    assert sim.budget_tracker.spent_usd == pytest.approx(res.total_cost)
    assert not sim.budget_tracker.exceeded


def test_simulator_tiny_budget_emits_budget_exceeded():
    env = cloudlab_environment()
    app = til_application(n_rounds=8)
    res = _base_chain(env, app).autopilot(budget=1e-6).simulate()
    exceeded = [e for e in res.trace if isinstance(e, BudgetExceeded)]
    assert exceeded  # mapper projection and/or tracker crossing
    sources = {e.source for e in exceeded}
    assert sources <= {"mapper", "tracker"}


def test_simulator_default_trace_carries_no_autopilot_events():
    env = cloudlab_environment()
    app = til_application(n_rounds=6)
    res = _base_chain(env, app).simulate()
    kinds = {type(e).__name__ for e in res.trace}
    assert not kinds & {"PriceUpdated", "DeadlineAdjusted", "BudgetExceeded"}
    vm_accruals = [e for e in res.trace
                   if isinstance(e, CostAccrued) and e.kind == "vm"]
    assert len(vm_accruals) == 1  # paper path: one end-of-run settlement


def test_simulator_risk_checkpointing_adds_checkpoints_under_churn():
    env = cloudlab_environment()
    app = til_application(n_rounds=10)

    def run(risk):
        chain = (Experiment.on(env).app(app)
                 .markets(clients="spot")
                 .revocations(k_r=1800, seed=5)
                 .checkpoints(every=8)
                 .async_rounds(deadline=app.t_round))
        if risk:
            chain = chain.autopilot(budget=100.0, risk_checkpointing=True)
        return chain.simulate()

    calm = run(False)
    risky = run(True)
    n_calm = sum(isinstance(e, CheckpointSaved) for e in calm.trace)
    n_risky = sum(isinstance(e, CheckpointSaved) for e in risky.trace)
    assert n_risky >= n_calm


def test_budgeted_runs_survive_mapping_market_override():
    # With a budget the mapper decides markets; the cfg markets are not
    # re-applied on top of its decision.
    env = cloudlab_environment()
    app = til_application(n_rounds=4)
    cfg = (_base_chain(env, app)
           .autopilot(budget=100.0, price_feed=SyntheticSpotFeed(seed=2))
           .build())
    sim = MultiCloudSimulator(env, app, cfg)
    res = sim.run()
    assert res.initial_mapping.placement[SERVER].market == "on_demand"


# ---------------------------------------------------------------------------
# End-to-end: live (in-process) target
# ---------------------------------------------------------------------------

def test_live_adaptive_deadline_emits_adjustments():
    from repro_torch.federated.async_server import DeterministicSchedule

    params = torch.zeros(4)
    clients = [StubClient.from_params(f"c{i}", params + i, 10)
               for i in range(4)]
    delays = {f"c{i}": 1.0 + 2.0 * i for i in range(4)}
    server = (Experiment()
              .async_rounds(deadline=5.0)
              .autopilot(adaptive_deadline=True)
              .serve(clients, params,
                     schedule=DeterministicSchedule(delays), device="cpu"))
    server.run(6)
    adjusted = [e for e in server.bus.trace if isinstance(e, DeadlineAdjusted)]
    assert adjusted, "controller must retune on the live bus"
    # Arrivals peak at 7s with slack 1.2: T walks up from 5s.
    assert adjusted[-1].new_t_round_s > 5.0


def test_live_adaptive_deadline_bootstraps_without_initial():
    from repro_torch.federated.async_server import DeterministicSchedule

    params = torch.zeros(2)
    clients = [StubClient.from_params(f"c{i}", params, 5) for i in range(2)]
    delays = {"c0": 1.0, "c1": 3.0}
    server = (Experiment()
              .async_rounds()
              .autopilot(adaptive_deadline=True)
              .serve(clients, params,
                     schedule=DeterministicSchedule(delays), device="cpu"))
    server.run(4)
    expired = [e for e in server.bus.trace if isinstance(e, DeadlineExpired)]
    assert expired  # the controller's proposal became a real deadline
