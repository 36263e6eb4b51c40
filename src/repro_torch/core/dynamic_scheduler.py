"""Dynamic Scheduler module (paper §4.4, Algorithms 1-3).

This is the port's own copy of ``repro/core/dynamic_scheduler.py``, which uses no JAX:
the same classes, fields and arithmetic, so both packages' schedulers
make the same decisions.  The port imports nothing of the JAX package;
the text below is the reference's, and its module names point into
that package.

On a VM revocation (or runtime fault) the Fault Tolerance module asks this
scheduler for a replacement VM for the faulty task.  Deadline-driven
partial rounds treat a silo that repeatedly misses T_round the same way —
a slow VM is a soft fault (`FaultToleranceModule.handle_straggler`), so
its reassignment routes through `select_instance` and the slow type enters
the same revocation cooldown. The choice is greedy:
for every candidate instance, recompute the expected round makespan
(Algorithm 1) and financial cost (Algorithm 2) with the candidate standing
in for the faulty task, and pick the candidate minimizing the same
normalized objective as the Initial Mapping (Algorithm 3):

    value = alpha * cost/cost_max + (1 - alpha) * makespan/T_max

With the cost autopilot attached (`repro.core.autopilot`), the scheduler
becomes market-aware: replacement candidates are ranked as (vm, market)
pairs at current feed prices, accrued-budget pressure tilts the
objective toward cost (alpha_eff -> 1 as the budget drains), and a task
whose cooldown history shows repeated spot revocations falls back to
on-demand replacements until the history decays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Mapping, Optional, Protocol, Set, Tuple

from .cloud_model import PriceFeed
from .cost_model import SERVER, Assignment, CostModel, Placement


class BudgetSignal(Protocol):
    """Accrued-budget state a cost-aware scheduler reads (implemented by
    `repro.core.autopilot.BudgetTracker`; a Protocol here so the core
    scheduler does not import the autopilot)."""

    def pressure(self) -> float:
        """Budget-drain pressure in [0, 1]: 0 = untouched, 1 = exhausted."""
        ...


@dataclasses.dataclass(frozen=True)
class ReplacementDecision:
    task: str
    new_vm: str
    market: str
    expected_makespan_s: float
    expected_cost: float
    objective_value: float
    candidates_considered: int


class DynamicScheduler:
    """Greedy replacement-instance selection."""

    def __init__(
        self,
        cost_model: CostModel,
        revoked_cooldown_s: float = 3600.0,
        price_feed: Optional[PriceFeed] = None,
        spot_fallback_after: int = 2,
    ) -> None:
        if spot_fallback_after < 1:
            raise ValueError("spot_fallback_after must be >= 1")
        self.cost_model = cost_model
        self.env = cost_model.env
        self.app = cost_model.app
        # Per-task revocation history: vm_id -> time the revocation happened.
        # The paper observed (on AWS) that a revoked type cannot be
        # reallocated in the same region *immediately* [47]; we model
        # "immediately" as a cooldown window rather than a permanent ban so a
        # long run cannot drain the pool into ever-slower instances.
        self.revoked_cooldown_s = revoked_cooldown_s
        self._revoked_at: Dict[str, Dict[str, float]] = {}
        # Cost-autopilot hooks.  With either set, select_instance ranks
        # (vm, market) pairs instead of keeping the faulty task's market
        # fixed; the default (both None) preserves the paper's behavior
        # — and existing traces — exactly.
        self.price_feed = price_feed
        self.budget: Optional[BudgetSignal] = None
        # A task revoked >= spot_fallback_after times on spot inside the
        # cooldown window stops being offered spot replacements until the
        # history decays (graceful fall-back to on-demand).
        self.spot_fallback_after = spot_fallback_after
        self._spot_revoked_at: Dict[str, List[float]] = {}

    # -- cost-autopilot state ------------------------------------------------
    @property
    def market_aware(self) -> bool:
        """True when autopilot hooks widen ranking to (vm, market) pairs."""
        return self.price_feed is not None or self.budget is not None

    def spot_revocations_in_window(self, task: str, now_s: float) -> int:
        """Spot revocations of ``task`` still inside the cooldown window."""
        return sum(
            1
            for t in self._spot_revoked_at.get(task, [])
            if now_s - t < self.revoked_cooldown_s
        )

    def _effective_alpha(self) -> float:
        """Eq.-3 alpha tilted toward cost as the budget drains."""
        alpha = self.cost_model.alpha
        if self.budget is None:
            return alpha
        pressure = min(1.0, max(0.0, self.budget.pressure()))
        return alpha + pressure * (1.0 - alpha)

    def candidate_set(self, task: str, now_s: float = 0.0) -> Set[str]:
        """I_t at time now_s: all VM types minus those inside their cooldown.

        The boundary is inclusive: a type revoked at ``t`` becomes
        eligible again exactly at ``t + revoked_cooldown_s`` (``>=``).
        An empty set is possible when every type is cooling down;
        `select_instance` then falls back to the full pool minus the VM
        that just died rather than dead-ending."""
        hist = self._revoked_at.get(task, {})
        return {
            vm_id
            for vm_id in self.env.vm_types
            if now_s - hist.get(vm_id, -math.inf) >= self.revoked_cooldown_s
        }

    # -- Algorithm 1 ---------------------------------------------------------
    def recompute_makespan(
        self, faulty_task: str, candidate_vm: str, current_map: Mapping[str, Assignment]
    ) -> float:
        cm = self.cost_model
        env = self.env
        if faulty_task == SERVER:
            # New server on candidate_vm; every client keeps its current VM.
            max_makespan = -math.inf
            svm = env.vm_types[candidate_vm]
            t_aggreg = cm.t_aggreg(candidate_vm)
            for c in self.app.clients:
                cvm = env.vm_types[current_map[c.client_id].vm_id]
                total = (
                    cm.t_exec(c.client_id, cvm.vm_id)
                    + cm.t_comm(cvm.region, svm.region)
                    + t_aggreg
                )
                max_makespan = max(max_makespan, total)
            return max_makespan
        # Faulty task is a client: server keeps its VM.
        svm = env.vm_types[current_map[SERVER].vm_id]
        t_aggreg = cm.t_aggreg(svm.vm_id)
        new_cvm = env.vm_types[candidate_vm]
        max_makespan = (
            cm.t_exec(faulty_task, candidate_vm)
            + cm.t_comm(new_cvm.region, svm.region)
            + t_aggreg
        )
        for c in self.app.clients:
            if c.client_id == faulty_task:
                continue
            cvm = env.vm_types[current_map[c.client_id].vm_id]
            total = (
                cm.t_exec(c.client_id, cvm.vm_id)
                + cm.t_comm(cvm.region, svm.region)
                + t_aggreg
            )
            max_makespan = max(max_makespan, total)
        return max_makespan

    # -- Algorithm 2 ---------------------------------------------------------
    def recompute_cost(
        self,
        faulty_task: str,
        candidate_vm: str,
        makespan_s: float,
        current_map: Mapping[str, Assignment],
        market: Optional[str] = None,
        now_s: float = 0.0,
    ) -> float:
        """Algorithm-2 round cost with ``candidate_vm`` standing in.

        ``market`` overrides the replacement's market (None keeps the
        faulty task's current one); with a `PriceFeed` on the cost model
        every VM is priced at its ``now_s`` quote instead of the static
        constant — without one this is byte-identical to the paper's
        fixed-price accounting."""
        cm = self.cost_model
        env = self.env
        total = 0.0
        if faulty_task == SERVER:
            new_server = env.vm_types[candidate_vm]
            new_market = market if market is not None else current_map[SERVER].market
            total += cm.price_per_second(candidate_vm, new_market, now_s) * makespan_s
            for c in self.app.clients:
                a = current_map[c.client_id]
                cvm = env.vm_types[a.vm_id]
                total += cm.price_per_second(a.vm_id, a.market, now_s) * makespan_s
                total += cm.comm_cost(cvm.provider, new_server.provider)
            return total
        server_a = current_map[SERVER]
        svm = env.vm_types[server_a.vm_id]
        total += cm.price_per_second(server_a.vm_id, server_a.market, now_s) * makespan_s
        new_cvm = env.vm_types[candidate_vm]
        new_market = market if market is not None else current_map[faulty_task].market
        total += cm.price_per_second(candidate_vm, new_market, now_s) * makespan_s
        total += cm.comm_cost(new_cvm.provider, svm.provider)
        for c in self.app.clients:
            if c.client_id == faulty_task:
                continue
            a = current_map[c.client_id]
            cvm = env.vm_types[a.vm_id]
            total += cm.price_per_second(a.vm_id, a.market, now_s) * makespan_s
            total += cm.comm_cost(cvm.provider, svm.provider)
        return total

    # -- Algorithm 3 ---------------------------------------------------------
    def select_instance(
        self,
        faulty_task: str,
        current_map: Mapping[str, Assignment],
        revoked_vm: str,
        remove_revoked: bool = True,
        candidate_override: Optional[Iterable[str]] = None,
        now_s: float = 0.0,
    ) -> ReplacementDecision:
        """Greedy selection of the replacement instance.

        `remove_revoked=True` follows the paper's default (a revoked type is
        not immediately reallocatable in the same region, observed on AWS);
        the ban decays after `revoked_cooldown_s`. CloudLab experiments
        (§5.6.1, Table 6) set it False so the same type may be re-selected
        right away.

        Without autopilot hooks the replacement keeps the faulty task's
        market (the paper's rule).  With a `PriceFeed` or a bound
        `BudgetSignal` the ranking widens to (vm, market) pairs priced
        at ``now_s``, the objective's alpha is tilted toward cost by the
        accrued-budget pressure, and a task with >= `spot_fallback_after`
        spot revocations inside the cooldown window is only offered
        on-demand replacements until that history decays.
        """
        cm = self.cost_model
        if remove_revoked:
            self._revoked_at.setdefault(faulty_task, {})[revoked_vm] = now_s
            if current_map[faulty_task].market == "spot":
                self._spot_revoked_at.setdefault(faulty_task, []).append(now_s)
        if candidate_override is not None:
            candidates: Set[str] = set(candidate_override)
            candidates.discard(revoked_vm)
        elif remove_revoked:
            candidates = self.candidate_set(faulty_task, now_s)
        else:
            # Same type may be re-picked immediately (CloudLab behaviour).
            candidates = set(self.env.vm_types)
        if not candidates:
            # Everything is inside its cooldown window; fall back to the full
            # pool minus the VM that just died rather than dead-ending.
            candidates = set(self.env.vm_types)
            candidates.discard(revoked_vm)
        if not candidates:
            raise RuntimeError(f"no candidate instances left for task {faulty_task!r}")

        current_market = current_map[faulty_task].market
        if not self.market_aware:
            markets: Tuple[str, ...] = (current_market,)
        elif (
            self.spot_revocations_in_window(faulty_task, now_s)
            >= self.spot_fallback_after
        ):
            markets = ("on_demand",)
        else:
            markets = ("on_demand", "spot")
        alpha = self._effective_alpha()
        best_vm: Optional[str] = None
        best_market = current_market
        best_value = math.inf
        best_ms = math.inf
        best_cost = math.inf
        for vm_id in sorted(candidates):
            ms = self.recompute_makespan(faulty_task, vm_id, current_map)
            for market in markets:
                cost = self.recompute_cost(
                    faulty_task, vm_id, ms, current_map,
                    market=market, now_s=now_s,
                )
                value = (
                    alpha * (cost / cm.cost_max())
                    + (1.0 - alpha) * (ms / cm.t_max())
                )
                if value < best_value:
                    best_value = value
                    best_vm = vm_id
                    best_market = market
                    best_ms = ms
                    best_cost = cost
        assert best_vm is not None
        return ReplacementDecision(
            task=faulty_task,
            new_vm=best_vm,
            market=best_market,
            expected_makespan_s=best_ms,
            expected_cost=best_cost,
            objective_value=best_value,
            candidates_considered=len(candidates),
        )
