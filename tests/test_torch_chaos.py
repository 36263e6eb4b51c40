"""The port's chaos harness against the reference's.

Mirrors tests/test_chaos.py (all but its four ``test_builder_*`` tests,
which wait for the port's ``Experiment`` builder; the driver is built
directly, as ``Experiment().chaos(plan).transport(...).serve(...)``
builds it in the reference): the seeded FaultPlan DSL, ChaosSchedule on
the virtual clock, ChaosClient and the LiveRoundDriver's chaos hooks on
the wall clock, heartbeat liveness (hang is not slow), reconnect
backoff, §4.4 cross-host VM replacement, and the soak: one plan, five
rounds, replayed on both drivers with equal per-round signatures and
conserved folded weight.  Where a plan or a virtual-clock run is
deterministic, the reference's gives the same result: seeded plans,
backoff delays, and the soak's signature and params.

Sizing against a loaded machine: clients are warmed up; heartbeats go
every 0.2 s with a 2 s no-PONG bound (the reference uses 0.05 s and
0.15 s), a slow silo sleeps twice that bound, and reply timeouts are at
least 3 s against training steps of a few ms.
"""
import os
import socket
import threading
import time

import pytest

from conftest import make_toy_app, make_toy_env
from repro.federated import AsyncFLServer as JaxAsyncServer
from repro.federated import ChaosSchedule as JaxChaosSchedule
from repro.federated import DeterministicSchedule as JaxDeterministic
from repro.federated import FaultPlan as JaxFaultPlan
from repro.federated import FaultSpec as JaxFaultSpec
from repro.federated import ReconnectPolicy as JaxReconnectPolicy
from repro.federated import chaos_signature as jax_chaos_signature
from repro.federated import checkpoint_saboteur as jax_checkpoint_saboteur
from repro.checkpoint import ClientCheckpointManager as JaxClientCkpt
from repro.checkpoint import ServerCheckpointManager as JaxServerCkpt
from repro.core.events import EventBus as JaxEventBus
from repro_torch.checkpoint import ClientCheckpointManager, ServerCheckpointManager
from repro_torch.core import Assignment, CostModel, DynamicScheduler
from repro_torch.core.events import (
    EventBus,
    FaultInjected,
    RecoveryCompleted,
    RevocationOccurred,
    RoundClosed,
    RoundDispatched,
    StragglerEscalated,
    UpdateArrived,
    UpdateFolded,
    VMReplaced,
)
from repro_torch.federated import (
    AsyncFLServer,
    ChaosSchedule,
    DeterministicSchedule,
    FaultPlan,
    FaultSpec,
    ReconnectPolicy,
    SocketTransport,
    chaos_signature,
    checkpoint_saboteur,
    corrupt_latest_checkpoint,
    run_client_worker,
    verify_fault_pairing,
)
from repro_torch.federated.chaos import CLIENT_KINDS, DRIVER_KINDS
from repro_torch.federated.transport import _connect_with_backoff
from test_torch_core_models import port_app, port_env
from test_torch_transport import (
    assert_params_close,
    init_params,
    jax_init_params,
    jax_paced_clients,
    live_driver,
    make_paced_clients,
)

HB = dict(heartbeat_interval_s=0.2, heartbeat_timeout_s=2.0)


# ---------------------------------------------------------------------------
# FaultPlan DSL
# ---------------------------------------------------------------------------

def test_fault_spec_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("meteor", "c0", 1)
    with pytest.raises(ValueError, match="phase"):
        FaultSpec("crash", "c0", 1, phase="warmup")
    with pytest.raises(ValueError, match="1-indexed"):
        FaultSpec("crash", "c0", 0)
    with pytest.raises(ValueError, match=">= 0"):
        FaultSpec("slow", "c0", 1, delay_s=-0.1)


def test_fault_plan_canonical_order_and_duplicate_rejection():
    plan = FaultPlan(
        [
            FaultSpec("slow", "c1", 3, delay_s=0.1),
            FaultSpec("crash", "c0", 1),
            FaultSpec("hang", "c0", 3, delay_s=0.1),
        ],
        seed=5,
    )
    assert [f.key for f in plan] == [
        ("crash", "c0", 1, "train"),
        ("hang", "c0", 3, "train"),
        ("slow", "c1", 3, "train"),
    ]
    assert len(plan) == 3
    assert plan.kinds == {"crash", "hang", "slow"}
    assert plan.max_round == 3
    assert [f.kind for f in plan.faults_for(3)] == ["hang", "slow"]
    assert [f.kind for f in plan.faults_for(3, task="c1")] == ["slow"]
    with pytest.raises(ValueError, match="duplicate"):
        FaultPlan([FaultSpec("crash", "c0", 1), FaultSpec("crash", "c0", 1)])


def test_seeded_plan_is_deterministic():
    kw = dict(n_rounds=5, tasks=["c0", "c1", "c2"], n_faults=6)
    a = FaultPlan.seeded(7, **kw)
    b = FaultPlan.seeded(7, **kw)
    assert a == b and len(a) == 6
    assert all(1 <= f.round_idx <= 5 for f in a)
    assert all(f.task in kw["tasks"] for f in a)
    assert all(f.kind in CLIENT_KINDS + DRIVER_KINDS for f in a)
    assert FaultPlan.seeded(8, **kw) != a
    with pytest.raises(ValueError, match="exceeds"):
        FaultPlan.seeded(0, n_rounds=1, tasks=["c0"], n_faults=99)
    # One seed, one plan, in either package.
    for seed in (0, 7, 8, 123):
        want = JaxFaultPlan.seeded(seed, **kw)
        got = FaultPlan.seeded(seed, **kw)
        assert [f.key + (f.delay_s, f.at_s) for f in got] == \
            [f.key + (f.delay_s, f.at_s) for f in want]


# ---------------------------------------------------------------------------
# Virtual-clock execution: ChaosSchedule
# ---------------------------------------------------------------------------

def test_chaos_schedule_rewrites_arrivals_and_publishes_markers():
    specs = [("slow", "c0", 1, dict(delay_s=0.5)), ("crash", "c1", 1, dict(at_s=0.05)),
             ("corrupt_frame", "c2", 1, {}), ("disconnect", "c0", 1, dict(phase="eval")),
             ("corrupt_checkpoint", "s", 1, {})]
    delays = {"c0": 0.1, "c1": 0.2, "c2": 0.3}
    plan = FaultPlan([FaultSpec(k, t, r, **kw) for k, t, r, kw in specs])
    bus = EventBus()
    sched = ChaosSchedule(DeterministicSchedule(delays), plan, bus=bus)
    arrivals = sched.round_arrivals(1, ["c0", "c1", "c2"])
    assert arrivals["c0"].delay_s == pytest.approx(0.6)
    assert arrivals["c0"].revoke_at_s is None
    assert arrivals["c1"].revoke_at_s == pytest.approx(0.05)
    assert arrivals["c2"].revoke_at_s == pytest.approx(0.3)
    markers = [e for e in bus.trace if isinstance(e, FaultInjected)]
    assert {(m.kind, m.task, m.phase) for m in markers} == {
        ("slow", "c0", "train"),
        ("crash", "c1", "train"),
        ("corrupt_frame", "c2", "train"),
        ("disconnect", "c0", "eval"),
    }
    clean = sched.round_arrivals(2, ["c0", "c1", "c2"])
    assert clean["c0"].delay_s == pytest.approx(0.1)
    assert all(a.revoke_at_s is None for a in clean.values())
    # The reference's schedule rewrites the same arrivals and publishes
    # the same markers.
    jbus = JaxEventBus()
    jsched = JaxChaosSchedule(
        JaxDeterministic(delays),
        JaxFaultPlan([JaxFaultSpec(k, t, r, **kw) for k, t, r, kw in specs]), bus=jbus)
    want = jsched.round_arrivals(1, ["c0", "c1", "c2"])
    for cid in delays:
        assert (arrivals[cid].delay_s, arrivals[cid].revoke_at_s) == \
            (want[cid].delay_s, want[cid].revoke_at_s)
    assert [(type(e).__name__, vars(e)) for e in bus.trace] == \
        [(type(e).__name__, vars(e)) for e in jbus.trace]


def test_checkpoint_saboteur_corrupts_every_replica_once(tmp_path):
    mgr = ServerCheckpointManager(
        str(tmp_path / "local"), str(tmp_path / "remote"), interval_rounds=1
    )
    mgr.save(1, init_params(), blocking_transfer=True)
    sizes = {
        d: os.path.getsize(os.path.join(d, "round_1.ckpt"))
        for d in (mgr.local_dir, mgr.remote_dir)
    }
    plan = FaultPlan([FaultSpec("corrupt_checkpoint", "s", 2)])
    bus = EventBus()
    hook = checkpoint_saboteur(plan, mgr, bus)
    assert hook(1) is None
    assert hook(2) == "s"
    for d, before in sizes.items():
        assert os.path.getsize(os.path.join(d, "round_1.ckpt")) < before
    markers = [e for e in bus.trace if isinstance(e, FaultInjected)]
    assert [(m.kind, m.round_idx) for m in markers] == [("corrupt_checkpoint", 2)]
    assert hook(2) is None


def test_corrupt_latest_checkpoint_with_no_saves_is_a_noop(tmp_path):
    mgr = ServerCheckpointManager(str(tmp_path / "l"), str(tmp_path / "r"))
    assert corrupt_latest_checkpoint(mgr) == []


def test_verify_fault_pairing_outcomes():
    plan = FaultPlan(
        [
            FaultSpec("crash", "c0", 1),
            FaultSpec("slow", "c1", 1, delay_s=0.1),
            FaultSpec("disconnect", "c2", 1),
            FaultSpec("revocation", "c0", 2, phase="eval"),
            FaultSpec("corrupt_checkpoint", "s", 2),
            FaultSpec("hang", "c1", 2, delay_s=0.1),
        ]
    )
    trace = [
        FaultInjected(0.0, "crash", "c0", 1),
        FaultInjected(0.0, "slow", "c1", 1),
        FaultInjected(0.0, "disconnect", "c2", 1),
        RevocationOccurred(0.1, "c0", round_idx=1),
        UpdateArrived(0.2, 1, "c0", attempt=2),
        UpdateFolded(0.2, 1, "c0", 10.0, 10.0),
        RevocationOccurred(0.1, "c2", round_idx=1),
        UpdateFolded(0.3, 1, "c1", 10.0, 20.0),
        RoundClosed(0.4, 1, 0.4),
        FaultInjected(1.0, "corrupt_checkpoint", "s", 2),
        RecoveryCompleted(1.0, "s", 2, 0.0, "client_local:c1"),
        FaultInjected(1.0, "revocation", "c0", 2, phase="eval"),
        RoundClosed(1.5, 2, 0.5),
    ]
    out = verify_fault_pairing(plan, trace)
    assert out[("crash", "c0", 1, "train")] == "recovered"
    assert out[("slow", "c1", 1, "train")] == "delivered"
    assert out[("disconnect", "c2", 1, "train")] == "excluded"
    assert out[("revocation", "c0", 2, "eval")] == "metrics-only"
    assert out[("corrupt_checkpoint", "s", 2, "train")] == "restored"
    assert out[("hang", "c1", 2, "train")] == "unpaired"


def test_chaos_signature_sorts_within_round_segments():
    a = [
        RoundDispatched(0.0, 1, 2),
        UpdateArrived(0.1, 1, "c0", attempt=1),
        UpdateArrived(0.2, 1, "c1", attempt=1),
        RoundClosed(0.3, 1, 0.3),
    ]
    b = [a[0], a[2], a[1], a[3]]
    assert chaos_signature(a) == chaos_signature(b)
    c = a + [RoundDispatched(0.4, 2, 2), RoundClosed(0.5, 2, 0.1)]
    d = a[:3] + [RoundDispatched(0.4, 2, 2), a[3], RoundClosed(0.5, 2, 0.1)]
    assert chaos_signature(c) != chaos_signature(d)
    e = a + [VMReplaced(0.3, "c0", "vm0", "vm1", "spot", "revocation")]
    assert chaos_signature(e) == chaos_signature(a)


# ---------------------------------------------------------------------------
# Reconnect / backoff
# ---------------------------------------------------------------------------

def test_reconnect_policy_validation_and_deterministic_delays():
    with pytest.raises(ValueError, match="max_attempts"):
        ReconnectPolicy(max_attempts=0)
    with pytest.raises(ValueError, match="delays"):
        ReconnectPolicy(base_delay_s=0.0)
    with pytest.raises(ValueError, match="multiplier"):
        ReconnectPolicy(multiplier=0.5)
    with pytest.raises(ValueError, match="jitter_frac"):
        ReconnectPolicy(jitter_frac=1.0)
    kw = dict(max_attempts=5, base_delay_s=0.1, max_delay_s=0.3, jitter_frac=0.25, seed=3)
    p = ReconnectPolicy(**kw)
    d = p.delays("c0")
    assert d == p.delays("c0")
    assert d != p.delays("c1")
    assert len(d) == 4
    for i, delay in enumerate(d):
        nominal = min(0.1 * 2.0 ** i, 0.3)
        assert nominal * 0.75 <= delay <= nominal * 1.25
    # The same jittered timeline as the reference's, silo by silo.
    for salt in ("c0", "c1", "femnist_client_4"):
        assert p.delays(salt) == JaxReconnectPolicy(**kw).delays(salt)


def test_connect_without_policy_gives_up_after_one_attempt():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    t0 = time.monotonic()
    assert _connect_with_backoff(("127.0.0.1", port), 1.0, None, "x") is None
    assert time.monotonic() - t0 < 5.0


def test_worker_reconnect_backoff_survives_late_server():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    client = make_paced_clients({"c0": 0.0})[0]
    policy = ReconnectPolicy(max_attempts=200, base_delay_s=0.05, max_delay_s=0.1, seed=1)
    worker = threading.Thread(
        target=run_client_worker,
        args=(client, init_params(), ("127.0.0.1", port)),
        kwargs={"reconnect": policy},
        daemon=True,
    )
    worker.start()
    time.sleep(0.2)  # guarantee at least one refused connect
    transport = SocketTransport(port=port)
    try:
        transport.start()
        transport.wait_for_clients(["c0"], timeout_s=60.0)
        assert transport.is_live("c0")
        transport.send("c0", {"kind": "shutdown"})
    finally:
        transport.close()
    worker.join(timeout=30.0)
    assert not worker.is_alive()


# ---------------------------------------------------------------------------
# Heartbeat liveness: hang != slow
# ---------------------------------------------------------------------------

def test_hang_is_detected_by_heartbeats_and_recovered():
    plan = FaultPlan([FaultSpec("hang", "c1", 1)])
    clients = make_paced_clients({"c0": 0.0, "c1": 0.0})
    driver = live_driver(clients, chaos=plan, reply_timeout_s=60.0, **HB)
    t0 = time.monotonic()
    with driver:
        live = driver.run(2)
    # Detection ran off the 2 s heartbeat bound, not the 60 s reply
    # timeout (nor the hang's own 30 s bound).
    assert time.monotonic() - t0 < 25.0
    assert driver.cohort == ["c0", "c1"]
    revs = [e for e in driver.trace
            if isinstance(e, RevocationOccurred) and e.round_idx == 1]
    assert [e.task for e in revs] == ["c1"]
    arrivals = [e for e in driver.trace if isinstance(e, UpdateArrived) and e.task == "c1"]
    assert arrivals[0].attempt == 2
    pairing = verify_fault_pairing(plan, driver.trace)
    assert pairing[("hang", "c1", 1, "train")] == "recovered"
    assert len(live.rounds) == 2


def test_slow_silo_with_flowing_heartbeats_is_not_killed():
    """A silo whose compute is slow (4 s) but whose receive loop answers
    PONGs stays connected twice past the 2 s heartbeat bound."""
    clients = make_paced_clients({"c0": 0.0, "c1": 4.0})
    driver = live_driver(clients, reply_timeout_s=60.0, **HB)
    with driver:
        live = driver.run(1)
    assert [e for e in driver.trace if isinstance(e, RevocationOccurred)] == []
    folded = {e.task for e in driver.trace if isinstance(e, UpdateFolded)}
    assert folded == {"c0", "c1"}
    assert driver.cohort == ["c0", "c1"]
    assert len(live.rounds) == 1


# ---------------------------------------------------------------------------
# Boundary matrix on the live driver
# ---------------------------------------------------------------------------

def test_eval_phase_revocation_skips_metrics_and_rejoins():
    plan = FaultPlan([FaultSpec("revocation", "c1", 1, phase="eval")])
    clients = make_paced_clients({"c0": 0.0, "c1": 0.05})
    driver = live_driver(clients, chaos=plan, reply_timeout_s=60.0)
    with driver:
        live = driver.run(2)
    assert set(live.rounds[0].fold_times_s) == {"c0", "c1"}
    assert live.rounds[0].metrics
    assert driver.cohort == ["c0", "c1"]
    assert set(live.rounds[1].fold_times_s) == {"c0", "c1"}
    assert [e for e in driver.trace if isinstance(e, RevocationOccurred)] == []
    pairing = verify_fault_pairing(plan, driver.trace)
    assert pairing[("revocation", "c1", 1, "eval")] == "metrics-only"


def test_double_crash_same_silo_same_round_recovers_on_third_attempt():
    clients = make_paced_clients({"c0": 0.0, "c1": 0.05}, crash_on={"c1": (1, 2)})
    driver = live_driver(clients, reply_timeout_s=60.0, max_rerequests=2)
    with driver:
        live = driver.run(1)
    assert driver.fold_reports[0].rerequested == ["c1"]
    assert not driver.fold_reports[0].excluded
    assert driver.cohort == ["c0", "c1"]
    assert clients[1]._attempts == 3
    arrivals = [e for e in driver.trace if isinstance(e, UpdateArrived) and e.task == "c1"]
    assert [e.attempt for e in arrivals] == [2]
    folded = [e.task for e in driver.trace if isinstance(e, UpdateFolded)]
    assert sorted(folded) == ["c0", "c1"]
    assert len(live.rounds) == 1


def test_crash_recovery_racing_reply_timeout_is_consistent():
    """A crash whose recovery lands right at the reply-timeout tick (the
    retrain sleeps 3 s, the window is 3 s; c0 takes a few ms) resolves
    either way without double-folding, wedging the round, or a
    straggler strike."""
    clients = make_paced_clients({"c0": 0.0, "c1": 0.0}, crash_on={"c1": (1,)})
    clients[1].delay_s = [0.0, 3.0, 0.0]
    driver = live_driver(clients, reply_timeout_s=3.0, escalate_after=1)
    with driver:
        live = driver.run(2)
    r1_folds = [e for e in driver.trace
                if isinstance(e, UpdateFolded) and e.task == "c1" and e.round_idx == 1]
    assert len(r1_folds) <= 1
    report = driver.fold_reports[0]
    assert "c0" not in report.excluded
    if report.excluded:
        assert report.excluded == ["c1"]
    else:
        assert report.rerequested == ["c1"]
    assert [e for e in driver.trace if isinstance(e, StragglerEscalated)] == []
    assert len(live.rounds) == 2


def test_corrupt_frame_rerequests_over_live_connection():
    plan = FaultPlan([FaultSpec("corrupt_frame", "c1", 1)])
    clients = make_paced_clients({"c0": 0.0, "c1": 0.05})
    driver = live_driver(clients, chaos=plan, reply_timeout_s=60.0)
    with driver:
        live = driver.run(2)
    arrivals = [e for e in driver.trace
                if isinstance(e, UpdateArrived) and e.task == "c1" and e.round_idx == 1]
    assert [e.attempt for e in arrivals] == [2]
    assert driver.cohort == ["c0", "c1"]
    pairing = verify_fault_pairing(plan, driver.trace)
    assert pairing[("corrupt_frame", "c1", 1, "train")] == "recovered"
    assert len(live.rounds) == 2


# ---------------------------------------------------------------------------
# §4.4 cross-host replacement
# ---------------------------------------------------------------------------

def _toy_scheduler(n_clients=3, n_vms=3):
    env = port_env(make_toy_env(n_vms=n_vms))
    app = port_app(make_toy_app(n_clients=n_clients))
    return DynamicScheduler(CostModel(env, app, 0.5))


def test_restart_lands_on_a_different_host_via_scheduler():
    plan = FaultPlan([FaultSpec("revocation", "c1", 1)])
    clients = make_paced_clients({"c0": 0.0, "c1": 0.05})
    placement = {
        "s": Assignment("vm0", "on_demand"),
        "c0": Assignment("vm0", "on_demand"),
        "c1": Assignment("vm1", "spot"),
    }
    driver = live_driver(clients, chaos=plan, reply_timeout_s=60.0,
                         scheduler=_toy_scheduler(n_clients=2), placement=placement)
    with driver:
        live = driver.run(2)
    replaced = [e for e in driver.trace if isinstance(e, VMReplaced)]
    assert len(replaced) == 1
    ev = replaced[0]
    assert ev.task == "c1" and ev.old_vm == "vm1"
    assert ev.new_vm != "vm1"
    assert placement["c1"].vm_id == ev.new_vm
    assert driver.workers.host_of("c1") == ev.new_vm
    assert driver.cohort == ["c0", "c1"]
    pairing = verify_fault_pairing(plan, driver.trace)
    assert pairing[("revocation", "c1", 1, "train")] == "recovered"
    assert len(live.rounds) == 2


# ---------------------------------------------------------------------------
# The capstone: seeded multi-fault soak, sim vs live
# ---------------------------------------------------------------------------

SOAK = [
    ("crash", "c0", 1, {}),
    ("slow", "c1", 2, dict(delay_s=0.25)),
    ("corrupt_frame", "c2", 2, {}),
    ("hang", "c1", 3, dict(delay_s=0.25)),
    ("revocation", "c0", 4, {}),
    ("corrupt_checkpoint", "s", 4, {}),
]
SOAK_DELAYS = {"c0": 0.0, "c1": 0.05, "c2": 0.1}
SOAK_N = (12, 20, 16)


def _ckpt_managers(root, server_cls=ServerCheckpointManager, client_cls=ClientCheckpointManager):
    server = server_cls(str(root / "server_local"), str(root / "server_remote"),
                        interval_rounds=1, keep_last=3)
    clients = {cid: client_cls(str(root / f"ckpt_{cid}")) for cid in ("c0", "c1", "c2")}
    return server, clients


def _per_round_folded_weights(trace):
    sums = {}
    for e in trace:
        if type(e).__name__ == "UpdateFolded":
            sums[e.round_idx] = sums.get(e.round_idx, 0.0) + e.weight
    return sums


def test_chaos_soak_sim_vs_live(tmp_path):
    """One seeded plan, five rounds, five fault kinds (checkpoint sabotage
    and a §4.4 cross-host replacement among them), replayed on the
    wall-clock driver and on the virtual-clock server of each package:
    every fault paired, folded weight conserved, per-round signatures
    equal, final params equal, wall time bounded."""
    plan = FaultPlan([FaultSpec(k, t, r, **kw) for k, t, r, kw in SOAK], seed=7)

    live_server_ckpt, live_client_ckpts = _ckpt_managers(tmp_path / "live")
    placement = {cid: Assignment("vm0", "spot") for cid in ("s", "c0", "c1", "c2")}
    driver = live_driver(
        make_paced_clients(SOAK_DELAYS, n_examples=SOAK_N), chaos=plan,
        reply_timeout_s=60.0, max_rerequests=2, scheduler=_toy_scheduler(),
        placement=placement, server_ckpt=live_server_ckpt, client_ckpts=live_client_ckpts, **HB)
    t0 = time.monotonic()
    with driver:
        live = driver.run(5)
    assert time.monotonic() - t0 < 120.0

    sim_server_ckpt, sim_client_ckpts = _ckpt_managers(tmp_path / "sim")
    bus = EventBus()
    server = AsyncFLServer(
        make_paced_clients(SOAK_DELAYS, n_examples=SOAK_N), init_params(),
        schedule=ChaosSchedule(DeterministicSchedule({"c0": 0.01, "c1": 0.02, "c2": 0.03}),
                               plan, bus=bus),
        on_revocation="rerequest", max_rerequests=2, bus=bus,
        server_ckpt=sim_server_ckpt, client_ckpts=sim_client_ckpts,
        fault_hook=checkpoint_saboteur(plan, sim_server_ckpt, bus), device="cpu")
    sim = server.run(5)

    jplan = JaxFaultPlan([JaxFaultSpec(k, t, r, **kw) for k, t, r, kw in SOAK], seed=7)
    ref_server_ckpt, ref_client_ckpts = _ckpt_managers(tmp_path / "ref", JaxServerCkpt,
                                                       JaxClientCkpt)
    jbus = JaxEventBus()
    ref = JaxAsyncServer(
        jax_paced_clients(SOAK_DELAYS, n_examples=SOAK_N), jax_init_params(),
        schedule=JaxChaosSchedule(JaxDeterministic({"c0": 0.01, "c1": 0.02, "c2": 0.03}),
                                  jplan, bus=jbus),
        on_revocation="rerequest", max_rerequests=2, bus=jbus,
        server_ckpt=ref_server_ckpt, client_ckpts=ref_client_ckpts,
        fault_hook=jax_checkpoint_saboteur(jplan, ref_server_ckpt, jbus))
    ref_run = ref.run(5)

    for trace in (driver.trace, server.bus.trace):
        pairing = verify_fault_pairing(plan, trace)
        assert "unpaired" not in pairing.values(), pairing
    live_pairing = verify_fault_pairing(plan, driver.trace)
    assert live_pairing[("corrupt_checkpoint", "s", 4, "train")] == "restored"
    assert live_pairing[("slow", "c1", 2, "train")] == "delivered"
    for key, want in [
        (("crash", "c0", 1, "train"), "recovered"),
        (("corrupt_frame", "c2", 2, "train"), "recovered"),
        (("hang", "c1", 3, "train"), "recovered"),
        (("revocation", "c0", 4, "train"), "recovered"),
    ]:
        assert live_pairing[key] == want

    for trace in (driver.trace, server.bus.trace, ref.bus.trace):
        weights = _per_round_folded_weights(trace)
        assert sorted(weights) == [1, 2, 3, 4, 5]
        for r, sum_w in weights.items():
            assert sum_w == pytest.approx(48.0), (r, sum_w)

    assert chaos_signature(driver.trace) == chaos_signature(server.bus.trace)
    assert chaos_signature(driver.trace) == jax_chaos_signature(ref.bus.trace)

    replaced = [e for e in driver.trace if isinstance(e, VMReplaced)]
    assert replaced and all(e.new_vm != e.old_vm for e in replaced)
    assert any(e.task == "c0" for e in replaced)

    recoveries = [e for e in driver.trace if isinstance(e, RecoveryCompleted)]
    assert [e.resume_round for e in recoveries] == [4]
    assert recoveries[0].restored_from != "none"

    assert_params_close(live.final_params, sim.final_params)
    assert_params_close(live.final_params, ref_run.final_params)
    assert driver.cohort == ["c0", "c1", "c2"]
    assert len(live.rounds) == len(sim.rounds) == len(ref_run.rounds) == 5
