"""The port's simulator: the reference's tests/test_simulator.py run on
``repro_torch.core``.

Multi-cloud execution simulator (§5 experiment engine), including
deadline-driven partial rounds (T_round folding, carry-over accounting,
and §4.4 straggler escalation through the Dynamic Scheduler)."""
import pytest

from repro_torch.core import (
    CheckpointPolicy,
    MultiCloudSimulator,
    SimulationConfig,
    cloudlab_environment,
    til_application,
    shakespeare_application,
)


# The port's testbed, as tests/conftest.py's fixture builds the reference's.
@pytest.fixture(scope="module")
def cloudlab_env():
    return cloudlab_environment()


def test_no_revocation_deterministic(cloudlab_env):
    app = til_application(n_rounds=10)
    cfg = SimulationConfig(k_r=None, vm_startup_s=1200.0)
    r1 = MultiCloudSimulator(cloudlab_env, app, cfg).run()
    r2 = MultiCloudSimulator(cloudlab_env, app, cfg).run()
    assert r1.total_time_s == r2.total_time_s
    assert r1.total_cost == r2.total_cost
    assert r1.n_revocations == 0


def test_paper_runtime_prediction(cloudlab_env):
    """§5.4: 10 rounds predicted at 22:38 (1358 s) of FL execution."""
    app = til_application(n_rounds=10)
    cfg = SimulationConfig(k_r=None, vm_startup_s=1200.0)
    res = MultiCloudSimulator(cloudlab_env, app, cfg).run()
    assert res.fl_exec_time_s == pytest.approx(1358, rel=0.02)


def test_spot_cheaper_than_on_demand_without_revocations(cloudlab_env):
    app = til_application(n_rounds=10)
    od = MultiCloudSimulator(cloudlab_env, app, SimulationConfig(k_r=None)).run()
    spot = MultiCloudSimulator(
        cloudlab_env, app, SimulationConfig(server_market="spot", client_market="spot", k_r=None)
    ).run()
    assert spot.total_cost < od.total_cost
    # ~70% discount on every VM -> ~70% cheaper runs (placement may shift
    # slightly since the optimizer sees spot rates).
    assert spot.vm_cost == pytest.approx(od.vm_cost * 0.3, rel=0.05)


def test_revocations_increase_with_rate(cloudlab_env):
    app = til_application(n_rounds=30)
    def total_revs(kr):
        return sum(
            MultiCloudSimulator(
                cloudlab_env, app,
                SimulationConfig(server_market="spot", client_market="spot",
                                 k_r=kr, seed=s, remove_revoked=False,
                                 checkpoint=CheckpointPolicy(server_interval_rounds=10)),
            ).run().n_revocations
            for s in range(5)
        )
    assert total_revs(1800) > total_revs(14400)


def test_on_demand_never_revokes(cloudlab_env):
    app = til_application(n_rounds=20)
    res = MultiCloudSimulator(
        cloudlab_env, app, SimulationConfig(k_r=600, seed=0)  # absurdly high rate
    ).run()
    assert res.n_revocations == 0  # all tasks on-demand -> no spot victims


def test_server_on_demand_only_clients_revoke(cloudlab_env):
    app = til_application(n_rounds=40)
    res = MultiCloudSimulator(
        cloudlab_env, app,
        SimulationConfig(server_market="on_demand", client_market="spot",
                         k_r=1800, seed=1, remove_revoked=False,
                         checkpoint=CheckpointPolicy(server_interval_rounds=10)),
    ).run()
    assert all(e.task != "s" for e in res.events)


def test_checkpoint_overhead_positive_and_small(cloudlab_env):
    app = til_application(n_rounds=40)
    base = MultiCloudSimulator(cloudlab_env, app, SimulationConfig(k_r=None)).run()
    ck = MultiCloudSimulator(
        cloudlab_env, app,
        SimulationConfig(k_r=None, checkpoint=CheckpointPolicy(server_interval_rounds=10)),
    ).run()
    assert ck.checkpoint_overhead_s > 0
    overhead = (ck.fl_exec_time_s - base.fl_exec_time_s) / base.fl_exec_time_s
    assert 0 < overhead < 0.15  # paper reports 2-8%


def test_rounds_all_complete_under_failures(cloudlab_env):
    app = shakespeare_application(n_rounds=20)
    res = MultiCloudSimulator(
        cloudlab_env, app,
        SimulationConfig(server_market="spot", client_market="spot", k_r=3600,
                         seed=3, remove_revoked=False,
                         checkpoint=CheckpointPolicy(server_interval_rounds=10)),
    ).run()
    assert res.rounds_completed == 20
    assert res.total_time_s > 0 and res.total_cost > 0


def test_async_rounds_never_slower_than_barrier(cloudlab_env):
    """Streaming-fold accounting: folds pipeline behind arrivals, so the
    async round span is <= the barrier span on every config — with
    equality only when every silo arrives simultaneously (TIL's four
    identical clients) and strict improvement on heterogeneous arrivals
    (Shakespeare's ragged silos)."""
    til = til_application(n_rounds=10)
    barrier = MultiCloudSimulator(cloudlab_env, til, SimulationConfig(k_r=None)).run()
    stream = MultiCloudSimulator(
        cloudlab_env, til, SimulationConfig(k_r=None, async_rounds=True)
    ).run()
    assert stream.rounds_completed == 10
    # identical clients -> simultaneous arrivals -> degenerate barrier cost
    assert stream.fl_exec_time_s == pytest.approx(barrier.fl_exec_time_s)

    shak = shakespeare_application(n_rounds=10)
    barrier = MultiCloudSimulator(cloudlab_env, shak, SimulationConfig(k_r=None)).run()
    stream = MultiCloudSimulator(
        cloudlab_env, shak, SimulationConfig(k_r=None, async_rounds=True)
    ).run()
    assert stream.fl_exec_time_s < barrier.fl_exec_time_s
    # the saving per round is bounded by the aggregation term the barrier
    # pays after the last arrival
    server_vm = barrier.final_placement["s"].vm_id
    cm = MultiCloudSimulator(cloudlab_env, shak, SimulationConfig(k_r=None)).cost_model
    max_save = 10 * cm.t_aggreg(server_vm)
    assert barrier.fl_exec_time_s - stream.fl_exec_time_s <= max_save + 1e-6


def test_async_round_time_accounting(cloudlab_env):
    """CostModel.async_round_time: folds serialize and pipeline."""
    app = til_application()
    cm = MultiCloudSimulator(cloudlab_env, app, SimulationConfig(k_r=None)).cost_model
    vm = next(iter(cloudlab_env.vm_types))
    t_fold = cm.t_fold(vm, 2)
    assert t_fold == pytest.approx(cm.t_aggreg(vm) / 2)
    # far-apart arrivals: each fold hides behind the next arrival
    span = cm.async_round_time({"a": 0.0, "b": 1000.0}, vm)
    assert span == pytest.approx(1000.0 + t_fold)
    # simultaneous arrivals: folds queue -> degenerate barrier cost
    span = cm.async_round_time({"a": 0.0, "b": 0.0}, vm)
    assert span == pytest.approx(2 * t_fold)


def test_async_rounds_survive_revocations(cloudlab_env):
    app = til_application(n_rounds=20)
    res = MultiCloudSimulator(
        cloudlab_env, app,
        SimulationConfig(server_market="spot", client_market="spot", k_r=3600,
                         seed=3, remove_revoked=False, async_rounds=True,
                         checkpoint=CheckpointPolicy(server_interval_rounds=10)),
    ).run()
    assert res.rounds_completed == 20
    assert res.total_time_s > 0 and res.total_cost > 0


def test_events_are_ordered_and_spot_only(cloudlab_env):
    app = til_application(n_rounds=60)
    res = MultiCloudSimulator(
        cloudlab_env, app,
        SimulationConfig(server_market="spot", client_market="spot", k_r=2000,
                         seed=5, remove_revoked=False,
                         checkpoint=CheckpointPolicy(server_interval_rounds=10)),
    ).run()
    times = [e.time_s for e in res.events]
    assert times == sorted(times)


# ---------------------------------------------------------------------------
# deadline-driven partial rounds (T_round folding in the round accounting)
# ---------------------------------------------------------------------------

def _slowest_cut_deadline(round_idx, offsets):
    """T_round just above the second-slowest arrival: the slowest silo
    misses every round (worst-case carry-over pressure)."""
    vals = sorted(offsets.values())
    return vals[-2] * 1.05


def test_deadline_round_time_accounting(cloudlab_env):
    """CostModel.deadline_round_time: quorum extension, carry-in folds,
    and the close-at-deadline vs close-at-drain split."""
    app = til_application()
    cm = MultiCloudSimulator(cloudlab_env, app, SimulationConfig(k_r=None)).cost_model
    vm = next(iter(cloudlab_env.vm_types))
    t_fold = cm.t_fold(vm, 2)
    offs = {"a": 0.0, "b": 1000.0}
    # b misses: the round holds until the deadline, a's fold hides inside
    plan = cm.deadline_round_time(offs, vm, deadline_s=10.0)
    assert plan.on_time == ("a",) and plan.late == ("b",)
    assert plan.effective_deadline_s == pytest.approx(10.0)
    assert plan.span_s == pytest.approx(max(10.0, t_fold))
    # quorum of 2 extends to b's arrival: nobody is late, close at drain
    plan = cm.deadline_round_time(offs, vm, deadline_s=10.0, min_clients=2)
    assert plan.late == () and plan.effective_deadline_s == pytest.approx(1000.0)
    assert plan.span_s == pytest.approx(1000.0 + t_fold)
    # carried messages from last round fold first (arrival 0)
    plan = cm.deadline_round_time(offs, vm, deadline_s=10.0, carry_in=3)
    assert plan.span_s == pytest.approx(max(10.0, 3 * t_fold + t_fold))
    # everyone in before the deadline: barrier-on-count closes the round
    # at the fold drain — identical to the PR-2 async accounting
    offs2 = {"a": 0.0, "b": 1.0}
    plan = cm.deadline_round_time(offs2, vm, deadline_s=1e6)
    assert plan.late == ()
    assert plan.span_s == pytest.approx(cm.async_round_time(offs2, vm))


def test_deadline_rounds_close_faster_than_barrier_on_count(cloudlab_env):
    """With a T_round that cuts the slowest silo, partial rounds beat the
    PR-2 barrier-on-count async engine on heterogeneous arrivals, and the
    misses/carried-fold accounting balances (no silo silently dropped)."""
    app = shakespeare_application(n_rounds=10)
    async_res = MultiCloudSimulator(
        cloudlab_env, app, SimulationConfig(k_r=None, async_rounds=True)
    ).run()
    res = MultiCloudSimulator(
        cloudlab_env, app,
        SimulationConfig(k_r=None, async_rounds=True,
                         round_deadline=_slowest_cut_deadline,
                         deadline_escalate_after=10**9),  # no escalations
    ).run()
    assert res.rounds_completed == 10
    assert res.fl_exec_time_s < async_res.fl_exec_time_s
    assert res.n_deadline_misses == 10          # one miss per round
    # every carried message eventually folds except the last round's
    assert res.carried_folds == res.n_deadline_misses - 1
    assert res.escalations == []


def test_deadline_escalation_replaces_slow_vm(cloudlab_env):
    """Two consecutive misses escalate the silo to the Dynamic Scheduler
    (§4.4 soft fault): its VM is swapped, the event is recorded, and the
    next-round start pays the replacement's startup delay."""
    app = shakespeare_application(n_rounds=6)
    cfg = SimulationConfig(k_r=None, async_rounds=True,
                           round_deadline=_slowest_cut_deadline,
                           deadline_escalate_after=2, vm_startup_s=100.0)
    sim = MultiCloudSimulator(cloudlab_env, app, cfg)
    res = sim.run()
    assert res.escalations, "chronic straggler must escalate"
    first = res.escalations[0]
    assert first.round_idx == 2                    # misses in rounds 1+2
    assert first.consecutive_misses == 2
    assert first.new_vm != first.old_vm
    # the victim's placement really moved off the initial mapping's VM
    assert res.final_placement[first.task].vm_id != res.initial_mapping.placement[first.task].vm_id or len(res.escalations) > 1
    # escalation startup delays show up in the makespan vs no-escalation
    no_esc = MultiCloudSimulator(
        cloudlab_env, app,
        SimulationConfig(k_r=None, async_rounds=True,
                         round_deadline=_slowest_cut_deadline,
                         deadline_escalate_after=10**9, vm_startup_s=100.0),
    ).run()
    assert res.fl_exec_time_s > no_esc.fl_exec_time_s


def test_huge_deadline_degenerates_to_async_accounting(cloudlab_env):
    """A T_round nobody can miss reproduces barrier-on-count async spans
    exactly (closing at the fold drain, no misses, no carries)."""
    app = shakespeare_application(n_rounds=10)
    async_res = MultiCloudSimulator(
        cloudlab_env, app, SimulationConfig(k_r=None, async_rounds=True)
    ).run()
    res = MultiCloudSimulator(
        cloudlab_env, app,
        SimulationConfig(k_r=None, async_rounds=True, round_deadline=1e9),
    ).run()
    assert res.n_deadline_misses == 0 and res.carried_folds == 0
    assert res.fl_exec_time_s == pytest.approx(async_res.fl_exec_time_s)


def test_round_deadline_requires_async_rounds(cloudlab_env):
    """The shim's __post_init__ rejects the silent misconfiguration at
    construction (it used to surface only deep inside run())."""
    with pytest.raises(ValueError):
        SimulationConfig(k_r=None, round_deadline=10.0)
    # mutating a built config past validation is still caught at run()
    cfg = SimulationConfig(k_r=None, async_rounds=True, round_deadline=10.0)
    cfg.async_rounds = False
    with pytest.raises(ValueError):
        MultiCloudSimulator(cloudlab_env, til_application(n_rounds=2), cfg).run()


def test_deadline_quorum_larger_than_cohort_rejected(cloudlab_env):
    """deadline_min_clients > n_silos can never meet quorum; the run
    rejects it up front (TIL has 4 clients)."""
    cfg = SimulationConfig(k_r=None, async_rounds=True, round_deadline=10.0,
                           deadline_min_clients=5)
    with pytest.raises(ValueError):
        MultiCloudSimulator(cloudlab_env, til_application(n_rounds=2), cfg).run()


def test_late_silo_revocation_does_not_interrupt_partial_round(cloudlab_env):
    """A revocation of a silo the deadline already cut must not re-run
    the round: the partial result stands (the round was not waiting on
    it) and the replacement is provisioned in the background — that
    decoupling is the whole point of T_round."""
    app = shakespeare_application(n_rounds=8)
    slowest = max(app.clients, key=lambda c: c.train_bl + c.test_bl).client_id
    hits = 0
    for seed in range(8):
        res = MultiCloudSimulator(
            cloudlab_env, app,
            SimulationConfig(server_market="on_demand", client_market="spot",
                             k_r=200.0, seed=seed, remove_revoked=False,
                             async_rounds=True,
                             round_deadline=_slowest_cut_deadline,
                             deadline_escalate_after=10**9),
        ).run()
        assert res.rounds_completed == 8
        # the slowest silo misses every round (remove_revoked=False keeps
        # placements stable), so none of its revocations may interrupt
        for e in res.events:
            if e.task == slowest:
                hits += 1
                assert not e.interrupted_round
    assert hits > 0  # the Poisson process did hit the late silo


def test_deadline_rounds_survive_revocations(cloudlab_env):
    """Partial rounds + spot revocations + checkpoints compose: the run
    still completes every round."""
    app = til_application(n_rounds=20)
    res = MultiCloudSimulator(
        cloudlab_env, app,
        SimulationConfig(server_market="spot", client_market="spot", k_r=3600,
                         seed=3, remove_revoked=False, async_rounds=True,
                         round_deadline=1e4,
                         checkpoint=CheckpointPolicy(server_interval_rounds=10)),
    ).run()
    assert res.rounds_completed == 20
    assert res.total_time_s > 0 and res.total_cost > 0
