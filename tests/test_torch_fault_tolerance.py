"""The port's Fault Tolerance module: the reference's
tests/test_fault_tolerance.py run on ``repro_torch.core``.

Fault Tolerance module (§4.3): checkpoint policy arithmetic, recovery
plans, freshest-wins restore decisions, and recovery-delay accounting."""
import pytest
try:  # hypothesis is an optional dev dependency (requirements-dev.txt)
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # property tests skip cleanly without it
    from _hypothesis_stub import given, settings, st

from repro_torch.core import (
    SERVER,
    Assignment,
    CheckpointPolicy,
    CostModel,
    DynamicScheduler,
    FaultToleranceModule,
    cloudlab_environment,
    til_application,
)


@pytest.fixture
def ft():
    env = cloudlab_environment()
    app = til_application()
    cm = CostModel(env, app, 0.5)
    sched = DynamicScheduler(cm)
    mod = FaultToleranceModule(
        scheduler=sched,
        policy=CheckpointPolicy(server_interval_rounds=10),
        checkpoint_bytes=504 * 1024 * 1024,
        vm_startup_s=120.0,
    )
    placement = {SERVER: Assignment("vm_121")}
    for c in app.clients:
        placement[c.client_id] = Assignment("vm_126", "spot")
    mod.register_tasks(placement)
    return mod, placement, app


def test_checkpoint_schedule():
    p = CheckpointPolicy(server_interval_rounds=10)
    assert p.server_checkpoints_at(10) and p.server_checkpoints_at(20)
    assert not p.server_checkpoints_at(9) and not p.server_checkpoints_at(11)
    assert not CheckpointPolicy(server_interval_rounds=0).server_checkpoints_at(10)


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 40), st.integers(1, 200))
def test_checkpoint_count_over_run(interval, rounds):
    p = CheckpointPolicy(server_interval_rounds=interval)
    n = sum(1 for r in range(1, rounds + 1) if p.server_checkpoints_at(r))
    assert n == rounds // interval


def test_save_overhead_scales_with_size():
    p = CheckpointPolicy(disk_bandwidth_Bps=100e6)
    assert p.save_overhead_s(504 * 1024 * 1024) == pytest.approx(5.285, rel=0.01)
    assert p.save_overhead_s(0) == 0.0


def test_round_complete_records_checkpoints(ft):
    mod, placement, app = ft
    ov = mod.on_round_complete(10, now_s=1000.0)
    assert ov > 0  # client save + server save
    # Server checkpoint becomes durable only after the async transfer.
    assert mod.latest_server_checkpoint(now_s=1000.0) is None
    transfer = mod.policy.transfer_time_s(mod.checkpoint_bytes)
    assert mod.latest_server_checkpoint(now_s=1000.0 + transfer + 1).round_idx == 10
    assert mod.latest_client_checkpoint().round_idx == 10


def test_server_fault_uses_freshest(ft):
    mod, placement, app = ft
    mod.on_round_complete(10, now_s=1000.0)  # server ckpt @10 (durable later)
    for r in (11, 12):
        mod.on_round_complete(r, now_s=1000.0 + 100 * (r - 10))
    # At t=1300 the server checkpoint may or may not be durable; clients
    # hold round 12 regardless -> restore source must be round 12.
    plan = mod.handle_fault(SERVER, placement, "vm_121", now_s=1300.0, current_round=13)
    assert plan.restore_from is not None
    assert plan.restore_from.round_idx == 12
    assert plan.resume_round == 13
    assert plan.decision.new_vm != "vm_121"


def test_server_fault_durable_server_ckpt_preferred(ft):
    mod, placement, app = ft
    mod.on_round_complete(10, now_s=0.0)
    # much later: transfer finished, no newer client rounds... clients have
    # 10 as well -> tie -> server's own checkpoint wins (no upload wait).
    plan = mod.handle_fault(SERVER, placement, "vm_121", now_s=1e6, current_round=11)
    assert plan.restore_from.location == "server_remote"


def test_client_fault_resumes_current_round(ft):
    mod, placement, app = ft
    victim = app.clients[0].client_id
    mod.on_round_complete(5, now_s=100.0)
    plan = mod.handle_fault(victim, placement, "vm_126", now_s=200.0, current_round=6)
    assert plan.resume_round == 6
    assert plan.restore_transfer_s == 0.0  # server re-sends weights anyway
    delay = mod.recovery_delay_s(plan)
    assert delay == pytest.approx(mod.vm_startup_s)


def test_recovery_log_grows(ft):
    mod, placement, app = ft
    mod.handle_fault(app.clients[0].client_id, placement, "vm_126", 10.0, 1)
    mod.handle_fault(SERVER, placement, "vm_121", 20.0, 1)
    assert len(mod.recovery_log) == 2
