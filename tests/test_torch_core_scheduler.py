"""The port's Initial Mapping, cost model and Dynamic Scheduler: the
reference's tests/test_core_scheduler.py run on ``repro_torch.core``.

Initial Mapping MILP + cost model + Dynamic Scheduler tests.

Property tests (hypothesis) check the exact solver against brute-force
enumeration on randomized small environments, and the published-testbed
tests validate against the paper's §5.4 numbers.
"""
import math

import pytest
try:  # hypothesis is an optional dev dependency (requirements-dev.txt)
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # property tests skip cleanly without it
    from _hypothesis_stub import given, settings, st

from test_torch_core_models import port_toy_app as make_toy_app
from test_torch_core_models import port_toy_env as make_toy_env
from repro_torch.core import (
    SERVER,
    Assignment,
    CostModel,
    DynamicScheduler,
    InitialMapping,
    cloudlab_environment,
    til_application,
)


# The port's testbed and TIL setup, as tests/conftest.py's fixtures build
# the reference's.
@pytest.fixture(scope="module")
def cloudlab_env():
    return cloudlab_environment()


@pytest.fixture
def til_setup(cloudlab_env):
    app = til_application()
    cm = CostModel(cloudlab_env, app, 0.5)
    placement = InitialMapping(cloudlab_env, app, alpha=0.5).solve().placement
    return cloudlab_env, app, cm, placement


# ---------------------------------------------------------------------------
# Random small environments for property tests
# ---------------------------------------------------------------------------

@st.composite
def small_problem(draw):
    """Randomized tiny env/app through the shared conftest builders."""
    n_vms = draw(st.integers(2, 4))
    n_clients = draw(st.integers(1, 3))
    env = make_toy_env(
        n_vms=n_vms,
        vm_regions=[draw(st.sampled_from(["r0", "r1"])) for _ in range(n_vms)],
        od_prices=[draw(st.floats(0.1, 10.0)) for _ in range(n_vms)],
        inst_slowdowns=[draw(st.floats(0.1, 3.0)) for _ in range(n_vms)],
        comm_slowdowns={
            ("r0", "r0"): draw(st.floats(0.5, 2.0)),
            ("r0", "r1"): draw(st.floats(0.5, 20.0)),
            ("r1", "r1"): draw(st.floats(0.5, 2.0)),
        },
        vcpus=[draw(st.integers(1, 16)) for _ in range(n_vms)],
        gpus=[draw(st.integers(0, 1)) for _ in range(n_vms)],
    )
    app = make_toy_app(
        n_clients=n_clients,
        train_bls=[draw(st.floats(10, 500)) for _ in range(n_clients)],
        test_bls=[draw(st.floats(1, 50)) for _ in range(n_clients)],
        train_comm_bl=draw(st.floats(1, 20)),
        test_comm_bl=draw(st.floats(0.5, 5)),
        aggreg_bl=draw(st.floats(0.1, 5)),
    )
    alpha = draw(st.floats(0.0, 1.0))
    return env, app, alpha


def brute_force(env, app, alpha):
    """Enumerate every placement; return the best feasible evaluation."""
    import itertools

    cm = CostModel(env, app, alpha)
    vm_ids = sorted(env.vm_types)
    best = None
    for server_vm in vm_ids:
        for assignment in itertools.product(vm_ids, repeat=app.n_clients):
            placement = {SERVER: Assignment(server_vm)}
            for c, vm in zip(app.clients, assignment):
                placement[c.client_id] = Assignment(vm)
            if not cm.capacity_ok(placement):
                continue
            ev = cm.evaluate(placement)
            if best is None or ev.objective < best.objective:
                best = ev
    return best


@settings(max_examples=30, deadline=None)
@given(small_problem())
def test_exact_solver_matches_brute_force(problem):
    env, app, alpha = problem
    im = InitialMapping(env, app, alpha=alpha)
    sol = im.solve()
    bf = brute_force(env, app, alpha)
    assert bf is not None
    assert sol.evaluation.objective == pytest.approx(bf.objective, rel=1e-9)


@settings(max_examples=20, deadline=None)
@given(small_problem())
def test_greedy_never_beats_exact(problem):
    env, app, alpha = problem
    im = InitialMapping(env, app, alpha=alpha)
    exact = im.solve().evaluation.objective
    greedy = im.solve_greedy().evaluation.objective
    assert greedy >= exact - 1e-12


@settings(max_examples=20, deadline=None)
@given(small_problem(), st.floats(0.1, 1e5))
def test_budget_constraint_respected(problem, budget):
    env, app, alpha = problem
    import dataclasses

    app_b = dataclasses.replace(app, budget_usd=budget)
    im = InitialMapping(env, app_b, alpha=alpha)
    try:
        sol = im.solve()
    except Exception:
        return  # infeasible is an acceptable outcome
    assert sol.evaluation.total_costs <= app_b.b_round + 1e-9


# ---------------------------------------------------------------------------
# Published-testbed validation (§5.4)
# ---------------------------------------------------------------------------

def test_til_cloudlab_placement_matches_paper():
    env = cloudlab_environment()
    app = til_application()
    sol = InitialMapping(env, app, alpha=0.5).solve()
    # Paper: 4 clients on the P100 node vm_126; server on a Wisconsin
    # 32-vCPU node (paper reports vm_121; vm_124 is its identically-priced
    # twin with marginally faster aggregation — equivalent optimum).
    for c in app.clients:
        assert sol.vm_of(c.client_id) == "vm_126"
    assert sol.vm_of(SERVER) in ("vm_121", "vm_124")
    # Paper: modeled runtime 22:38 for 10 rounds => 135.8 s/round.
    assert sol.evaluation.makespan_s == pytest.approx(135.8, rel=0.02)


def test_makespan_equals_slowest_client():
    env = cloudlab_environment()
    app = til_application()
    cm = CostModel(env, app, 0.5)
    placement = {SERVER: Assignment("vm_121")}
    for i, c in enumerate(app.clients):
        placement[c.client_id] = Assignment("vm_126" if i else "vm_114")
    ms = cm.makespan(placement)
    slowest = cm.client_round_time(app.clients[0].client_id, "vm_114", "vm_121")
    assert ms == pytest.approx(slowest)


def test_cost_max_upper_bounds_all_costs():
    env = cloudlab_environment()
    app = til_application()
    cm = CostModel(env, app, 0.5)
    import itertools

    vm_ids = sorted(env.vm_types)
    for server_vm in vm_ids[:4]:
        placement = {SERVER: Assignment(server_vm)}
        for c in app.clients:
            placement[c.client_id] = Assignment(vm_ids[0])
        ev = cm.evaluate(placement)
        assert ev.total_costs <= cm.cost_max() + 1e-9
        assert ev.makespan_s <= cm.t_max() + 1e-9


# ---------------------------------------------------------------------------
# Dynamic Scheduler (Algorithms 1-3)
# ---------------------------------------------------------------------------

def test_algorithm1_server_fault(til_setup):
    env, app, cm, placement = til_setup
    ds = DynamicScheduler(cm)
    ms = ds.recompute_makespan(SERVER, "vm_212", placement)
    # Manual: max over clients of exec + comm(client, new server) + aggreg.
    expected = max(
        cm.client_round_time(c.client_id, placement[c.client_id].vm_id, "vm_212")
        for c in app.clients
    )
    assert ms == pytest.approx(expected)


def test_algorithm1_client_fault(til_setup):
    env, app, cm, placement = til_setup
    ds = DynamicScheduler(cm)
    victim = app.clients[0].client_id
    server_vm = placement[SERVER].vm_id
    ms = ds.recompute_makespan(victim, "vm_138", placement)
    others = [
        cm.client_round_time(c.client_id, placement[c.client_id].vm_id, server_vm)
        for c in app.clients
        if c.client_id != victim
    ]
    mine = cm.client_round_time(victim, "vm_138", server_vm)
    assert ms == pytest.approx(max([mine] + others))


def test_algorithm3_removes_revoked(til_setup):
    env, app, cm, placement = til_setup
    ds = DynamicScheduler(cm)
    victim = app.clients[0].client_id
    revoked = placement[victim].vm_id
    dec = ds.select_instance(victim, placement, revoked, remove_revoked=True, now_s=0.0)
    assert dec.new_vm != revoked
    # paper observation (Table 5): client restarts move vm_126 -> vm_138.
    assert dec.new_vm == "vm_138"


def test_algorithm3_same_type_allowed_without_removal(til_setup):
    env, app, cm, placement = til_setup
    ds = DynamicScheduler(cm)
    victim = app.clients[0].client_id
    revoked = placement[victim].vm_id  # vm_126 — the best client VM
    dec = ds.select_instance(victim, placement, revoked, remove_revoked=False)
    # CloudLab mode (Table 6): the same best instance type is re-picked.
    assert dec.new_vm == revoked


def test_cooldown_replenishes_candidates(til_setup):
    env, app, cm, placement = til_setup
    ds = DynamicScheduler(cm, revoked_cooldown_s=100.0)
    victim = app.clients[0].client_id
    ds.select_instance(victim, placement, "vm_126", remove_revoked=True, now_s=0.0)
    assert "vm_126" not in ds.candidate_set(victim, now_s=50.0)
    assert "vm_126" in ds.candidate_set(victim, now_s=150.0)


def test_algorithm3_objective_consistent(til_setup):
    """The chosen VM minimizes alpha*cost/cost_max + (1-alpha)*ms/T_max."""
    env, app, cm, placement = til_setup
    ds = DynamicScheduler(cm)
    victim = app.clients[0].client_id
    dec = ds.select_instance(victim, placement, placement[victim].vm_id, remove_revoked=True)
    for vm_id in env.vm_types:
        if vm_id == placement[victim].vm_id:
            continue
        ms = ds.recompute_makespan(victim, vm_id, placement)
        cost = ds.recompute_cost(victim, vm_id, ms, placement)
        value = 0.5 * cost / cm.cost_max() + 0.5 * ms / cm.t_max()
        assert value >= dec.objective_value - 1e-12


# ---------------------------------------------------------------------------
# candidate_set cooldown semantics (regression pins)
# ---------------------------------------------------------------------------

def test_candidate_set_eligible_exactly_at_cooldown_boundary(til_setup):
    """The cooldown boundary is inclusive: a type revoked at t becomes
    eligible again exactly at t + revoked_cooldown_s (>=), not one tick
    later."""
    env, app, cm, placement = til_setup
    ds = DynamicScheduler(cm, revoked_cooldown_s=100.0)
    victim = app.clients[0].client_id
    ds.select_instance(victim, placement, "vm_126", remove_revoked=True, now_s=0.0)
    assert "vm_126" not in ds.candidate_set(victim, now_s=99.999)
    assert "vm_126" in ds.candidate_set(victim, now_s=100.0)  # exact boundary
    assert "vm_126" in ds.candidate_set(victim, now_s=100.001)


def test_candidate_set_cooldowns_are_per_task(til_setup):
    """One task's revocation history never shrinks another task's pool."""
    env, app, cm, placement = til_setup
    ds = DynamicScheduler(cm, revoked_cooldown_s=100.0)
    victim, other = app.clients[0].client_id, app.clients[1].client_id
    ds.select_instance(victim, placement, "vm_126", remove_revoked=True, now_s=0.0)
    assert "vm_126" not in ds.candidate_set(victim, now_s=0.0)
    assert "vm_126" in ds.candidate_set(other, now_s=0.0)


def test_select_instance_falls_back_when_every_candidate_is_cooling(til_setup):
    """With every VM type inside its cooldown window the scheduler must
    not dead-end: it falls back to the full pool minus the VM that just
    died rather than raising."""
    env, app, cm, placement = til_setup
    ds = DynamicScheduler(cm, revoked_cooldown_s=1e9)
    victim = app.clients[0].client_id
    for vm_id in env.vm_types:
        ds.select_instance(victim, placement, vm_id, remove_revoked=True, now_s=0.0)
    assert ds.candidate_set(victim, now_s=1.0) == set()
    revoked_vm = placement[victim].vm_id
    dec = ds.select_instance(victim, placement, revoked_vm,
                             remove_revoked=True, now_s=1.0)
    assert dec.new_vm != revoked_vm
    assert dec.candidates_considered == len(env.vm_types) - 1
