"""The port's resource manager against the reference's, exactly.

``repro_torch.core`` copies the reference's pure-Python modules (the
paper's Pre-Scheduling, Initial Mapping and Fault Tolerance, the
simulator, the autopilot and the control plane), so on the same inputs
every number they return must be equal (``==``), not close: the same
float arithmetic in the same order.  The grid is the published testbeds
(``cloudlab_environment()``, ``aws_gcp_environment()``) times the paper's
TIL, Shakespeare and FEMNIST applications times alpha in {0, 0.5, 1}.

Results are compared as trees of plain values (``norm``): a dataclass of
either package becomes its class name and fields, an enum its class and
member name.  Then the golden traces: each of ``scripts/golden_traces.py``'s
scenarios, rebuilt on the port's ``Experiment``, dumps the trace the
reference dumps fresh and matches ``tests/golden/<name>.json``.
"""
import dataclasses
import enum
import json
import os
import sys

import numpy as np
import pytest

from repro import core as rcore
from repro_torch import core as tcore

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from golden_traces import SCENARIOS, dump_scenario, golden_path  # noqa: E402
from trace_dump import diff_traces, trace_to_json  # noqa: E402

ENVS = ("cloudlab_environment", "aws_gcp_environment")
APPS = ("til_application", "shakespeare_application", "femnist_application")
ALPHAS = (0.0, 0.5, 1.0)
GRID = [(e, a, al) for e in ENVS for a in APPS for al in ALPHAS]


def norm(x):
    """A result of either package as plain values, for ``==``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, norm(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(norm(v) for v in x)
    return x


def both(name, *args, **kwargs):
    """``name`` built by each package: (reference's, port's)."""
    return (getattr(rcore, name)(*args, **kwargs), getattr(tcore, name)(*args, **kwargs))


def outcome(fn):
    """``fn()``'s value, or the error it raised (type name and message)."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 (both packages must raise alike)
        return ("raised", type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# §4.2 Initial Mapping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env_name,app_name,alpha", GRID)
def test_initial_mapping_equals_reference(env_name, app_name, alpha):
    (renv, tenv), (rapp, tapp) = both(env_name), both(app_name)
    rim = rcore.InitialMapping(renv, rapp, alpha=alpha)
    tim = tcore.InitialMapping(tenv, tapp, alpha=alpha)
    for solver in ("solve", "solve_greedy"):
        want = outcome(getattr(rim, solver))
        got = outcome(getattr(tim, solver))
        assert norm(got) == norm(want), solver
        if solver == "solve" and not isinstance(got, tuple):
            assert (got.nodes_explored, got.candidates_swept) == \
                (want.nodes_explored, want.candidates_swept)
            assert got.nodes_explored > 0 and got.evaluation.objective == want.evaluation.objective


# ---------------------------------------------------------------------------
# §4.1 Pre-Scheduling
# ---------------------------------------------------------------------------

def _probe(module, env, seed):
    """A CallableProbe of seeded timings, drawn over the sorted ids so both
    packages see the same numbers."""
    rng = np.random.default_rng(seed)
    vm = {v: (float(rng.uniform(10, 200)), float(rng.uniform(1, 20)))
          for v in sorted(env.vm_types)}
    regions = sorted(env.regions)
    pair = {(a, b): (float(rng.uniform(1, 30)), float(rng.uniform(0.5, 10)))
            for i, a in enumerate(regions) for b in regions[i:]}
    return module.CallableProbe(lambda v: module.ProbeResult(*vm[v]),
                                lambda a, b: module.ProbeResult(*pair[(a, b)]))


@pytest.mark.parametrize("env_name", ENVS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pre_scheduling_equals_reference(env_name, seed):
    renv, tenv = both(env_name)
    base_vm = sorted(renv.vm_types)[seed % len(renv.vm_types)]
    regions = sorted(renv.regions)
    base_pair = (regions[-1], regions[0])  # stored the other way round
    rps = rcore.PreScheduling(renv, _probe(rcore, renv, seed))
    tps = tcore.PreScheduling(tenv, _probe(tcore, tenv, seed))
    rres = rps.run(baseline_vm=base_vm, baseline_pair=base_pair, n_repeats=2)
    tres = tps.run(baseline_vm=base_vm, baseline_pair=base_pair, n_repeats=2)
    assert norm(tres) == norm(rres)
    rps.attach_to_environment(rres)
    tps.attach_to_environment(tres)
    assert tenv.sl_inst == renv.sl_inst and tenv.sl_comm == renv.sl_comm
    # The attached slowdowns drive the same placement.
    rapp, tapp = both("til_application")
    assert norm(tcore.InitialMapping(tenv, tapp).solve()) == \
        norm(rcore.InitialMapping(renv, rapp).solve())
    assert tcore.expected_exec_time(tenv, 3.0, 1.0, base_vm) == \
        rcore.expected_exec_time(renv, 3.0, 1.0, base_vm)
    assert tcore.expected_comm_time(tenv, 2.0, 0.5, regions[0], regions[-1]) == \
        rcore.expected_comm_time(renv, 2.0, 0.5, regions[0], regions[-1])


# ---------------------------------------------------------------------------
# §4.3 Fault Tolerance
# ---------------------------------------------------------------------------

def _recovery_story(module, env, app):
    """Checkpoints over seven rounds, then a server fault, two client
    faults (one revoked type kept, one removed) and a straggler: every
    plan, delay, overhead and the log."""
    sol = module.InitialMapping(env, app, alpha=0.5).solve()
    placement = dict(sol.placement)
    for cid in list(placement):
        if cid != module.SERVER:
            placement[cid] = module.Assignment(placement[cid].vm_id, "spot")
    ft = module.FaultToleranceModule(
        scheduler=module.DynamicScheduler(module.CostModel(env, app, 0.5)),
        policy=module.CheckpointPolicy(server_interval_rounds=3),
        checkpoint_bytes=app.checkpoint_bytes, vm_startup_s=120.0)
    ft.register_tasks(placement)
    overheads = [ft.on_round_complete(r, now_s=100.0 * r) for r in range(1, 8)]
    clients = [c.client_id for c in app.clients]
    plans = [
        ft.handle_fault(module.SERVER, placement, placement[module.SERVER].vm_id, 750.0, 8),
        ft.handle_fault(clients[0], placement, placement[clients[0]].vm_id, 760.0, 8),
        ft.handle_straggler(clients[-1], placement, placement[clients[-1]].vm_id, 770.0, 8),
    ]
    ft.remove_revoked = False
    plans.append(ft.handle_fault(clients[1], placement, placement[clients[1]].vm_id, 5e5, 9))
    return {
        "placement": placement, "overheads": overheads, "plans": plans,
        "delays": [ft.recovery_delay_s(p) for p in plans],
        "log": ft.recovery_log,
        "latest": (ft.latest_server_checkpoint(1e6), ft.latest_client_checkpoint()),
    }


@pytest.mark.parametrize("env_name", ENVS)
@pytest.mark.parametrize("app_name", APPS)
def test_fault_tolerance_plans_equal_reference(env_name, app_name):
    (renv, tenv), (rapp, tapp) = both(env_name), both(app_name)
    want = _recovery_story(rcore, renv, rapp)
    got = _recovery_story(tcore, tenv, tapp)
    assert norm(got) == norm(want)
    assert all(p.decision.new_vm for p in got["plans"])


# ---------------------------------------------------------------------------
# The simulator, through the builder
# ---------------------------------------------------------------------------

def _cut(round_idx, offsets):
    """Just above the second-slowest arrival: the slowest silo misses."""
    vals = sorted(offsets.values())
    return vals[-2] * 1.05 if len(vals) > 1 else vals[-1] * 1.05


CHAINS = {
    "on_demand": lambda exp: exp,
    "spot": lambda exp: (exp.markets(server="on_demand", clients="spot")
                         .revocations(k_r=1800.0, seed=3, remove_revoked=False)
                         .checkpoints(every=2)),
    "deadline": lambda exp: (exp.markets(server="spot", clients="spot")
                             .revocations(k_r=3600.0, seed=5)
                             .async_rounds(deadline=_cut, escalate_after=2)),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("env_name,app_name,alpha", GRID)
def test_simulation_equals_reference(env_name, app_name, alpha, chain):
    (renv, tenv), (rapp, tapp) = both(env_name), both(app_name, n_rounds=6)
    rres = CHAINS[chain](rcore.Experiment.on(renv).app(rapp).objective(alpha)).simulate()
    tres = CHAINS[chain](tcore.Experiment.on(tenv).app(tapp).objective(alpha)).simulate()
    assert (tres.fl_exec_time_s, tres.total_time_s, tres.total_cost) == \
        (rres.fl_exec_time_s, rres.total_time_s, rres.total_cost)
    assert trace_to_json(tres.trace) == trace_to_json(rres.trace)
    assert norm(tres) == norm(rres)
    assert tres.rounds_completed == 6


def test_simulation_grid_exercises_faults_and_deadlines():
    """The grid's chains are not all quiet: revocations, escalations and
    carried folds occur in it."""
    seen = set()
    for chain in ("spot", "deadline"):
        for app_name in APPS:
            res = CHAINS[chain](tcore.Experiment.on(tcore.cloudlab_environment())
                                .app(getattr(tcore, app_name)(n_rounds=6))).simulate()
            seen |= {type(e).__name__ for e in res.trace}
    assert {"RevocationOccurred", "VMReplaced", "CheckpointSaved", "DeadlineExpired",
            "StragglerEscalated"} <= seen


def test_measured_aggregation_hook_equals_reference():
    """``make_measured_aggreg_fn`` gives the reference's times, and a chain
    priced with it simulates as the reference's does."""
    from repro.federated import make_measured_aggreg_fn as jax_fn
    from repro_torch.federated import make_measured_aggreg_fn

    (renv, tenv), (rapp, tapp) = both("cloudlab_environment"), both("femnist_application",
                                                                     n_rounds=5)
    args = (5 * 656_748_280, 116.3)
    rfn, tfn = jax_fn(renv, *args, base_vm_id="vm_121"), make_measured_aggreg_fn(
        tenv, *args, base_vm_id="vm_121")
    assert [tfn(v) for v in sorted(tenv.vm_types)] == [rfn(v) for v in sorted(renv.vm_types)]
    with pytest.raises(ValueError, match="gb_per_s"):
        make_measured_aggreg_fn(tenv, 1, 0.0)
    rres = rcore.Experiment.on(renv).app(rapp).aggregation(aggreg_time_fn=rfn).simulate()
    tres = tcore.Experiment.on(tenv).app(tapp).aggregation(aggreg_time_fn=tfn).simulate()
    assert norm(tres) == norm(rres)
    static = tcore.Experiment.on(tenv).app(tapp).simulate()
    assert tres.fl_exec_time_s < static.fl_exec_time_s


# ---------------------------------------------------------------------------
# Golden traces
# ---------------------------------------------------------------------------

def _port_scenario(name):
    """``scripts/golden_traces.py``'s scenario, built on the port."""
    exp = tcore.Experiment.on(tcore.cloudlab_environment())
    if name == "til_baseline":
        return exp.app(tcore.til_application(n_rounds=6))
    if name == "spot_revocations":
        return (exp.app(tcore.til_application(n_rounds=8))
                .markets(server="on_demand", clients="spot")
                .revocations(k_r=3600.0, seed=0, remove_revoked=False))
    assert name == "async_deadline"
    return exp.app(tcore.shakespeare_application(n_rounds=6)).async_rounds(deadline=400.0)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_golden_trace_equals_reference_and_golden(name):
    got = trace_to_json(_port_scenario(name).simulate().trace)
    assert got == dump_scenario(name)
    with open(golden_path(name)) as f:
        golden = json.load(f)
    assert diff_traces(golden, got, label_a="golden", label_b="port")
