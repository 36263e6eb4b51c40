"""Makespan / financial-cost model shared by the Initial Mapping MILP and
the Dynamic Scheduler (paper Eqs. 1-7 and Algorithms 1-2).

This is the port's own copy of ``repro/core/cost_model.py``, which uses no JAX:
the same classes, fields and arithmetic, so both packages' schedulers
make the same decisions.  The port imports nothing of the JAX package;
the text below is the reference's, and its module names point into
that package.

A *placement* maps each task (server "s" or client id) to a (vm_id, market)
pair, where market is "on_demand" or "spot".
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

from .application_model import FLApplication, MessageSizes
from .cloud_model import CloudEnvironment, PriceFeed, VMType

SERVER = "s"


@dataclasses.dataclass(frozen=True)
class Assignment:
    """One task's placement."""

    vm_id: str
    market: str = "on_demand"  # "on_demand" | "spot"


Placement = Dict[str, Assignment]  # task id ("s" or client id) -> Assignment


@dataclasses.dataclass(frozen=True)
class PlacementEvaluation:
    makespan_s: float          # t_m
    vm_costs: float            # Eq. 4
    comm_costs: float          # Eq. 5
    total_costs: float         # vm_costs + comm_costs
    objective: float           # Eq. 3, normalized


@dataclasses.dataclass(frozen=True)
class DeadlineRoundPlan:
    """`CostModel.deadline_round_time` output: who made the round's cut.

    ``span_s`` is the round's dispatch->close time; ``on_time``/``late``
    partition the clients by the effective (quorum-extended) deadline —
    late clients' updates carry into the next round's average."""

    span_s: float
    effective_deadline_s: float
    on_time: Tuple[str, ...]
    late: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """`CostModel.round_plan` output: one round's accounting under any of
    the three protocols (barrier / streaming fold / T_round deadline).

    ``client_times`` maps each client to its round-relative completion
    offset (arrival for the streaming modes, arrival + aggregation for
    the barrier); ``deadline`` is the partial-round partition when a
    T_round was given, else None."""

    span_s: float
    client_times: Dict[str, float]
    deadline: Optional[DeadlineRoundPlan] = None
    policy_deadline_s: Optional[float] = None


class CostModel:
    """Evaluates placements for one FL application on one environment."""

    def __init__(
        self,
        env: CloudEnvironment,
        app: FLApplication,
        alpha: float = 0.5,
        aggreg_time_fn: Optional[Callable[[str], float]] = None,
        price_feed: Optional[PriceFeed] = None,
    ) -> None:
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be in [0, 1]")
        self.env = env
        self.app = app
        self.alpha = alpha
        # Optional hook: vm_id -> seconds, e.g. built from the measured
        # aggregation-engine bandwidth (repro.federated.agg_engine
        # .make_measured_aggreg_fn) instead of the static aggreg_bl.
        self.aggreg_time_fn = aggreg_time_fn
        # Optional time-varying spot market (repro.core.cloud_model
        # PriceFeed); None keeps the paper's fixed cost_{jkl} constants.
        self.price_feed = price_feed
        self._t_max: Optional[float] = None
        self._cost_max: Optional[float] = None

    # -- time-varying prices -------------------------------------------------
    def price_per_second(
        self, vm_id: str, market: str, now_s: float = 0.0
    ) -> float:
        """cost_{jkl} at ``now_s``: feed-quoted for spot markets when a
        `PriceFeed` is configured, else the static listed rate."""
        vm = self.env.vm_types[vm_id]
        if self.price_feed is not None:
            return self.price_feed.price_per_second(vm, market, now_s)
        return vm.cost_per_second(market)

    def vm_cost_between(
        self, vm_id: str, market: str, t0: float, t1: float
    ) -> float:
        """$ for occupying ``vm_id`` over [t0, t1] — the billing-ledger
        primitive: piecewise-exact under a feed, rate x span without."""
        vm = self.env.vm_types[vm_id]
        if self.price_feed is not None:
            return self.price_feed.cost_between(vm, market, t0, t1)
        return vm.cost_per_second(market) * max(0.0, t1 - t0)

    # -- primitive terms ----------------------------------------------------
    def t_exec(self, client_id: str, vm_id: str) -> float:
        """Eq. 2: client exec time (train + test) on vm."""
        c = self.app.client(client_id)
        return (c.train_bl + c.test_bl) * self.env.inst_slowdown(vm_id)

    def t_comm(self, region_a: str, region_b: str) -> float:
        """Eq. 1: round-trip message time between two regions."""
        sl = self.env.comm_slowdown(region_a, region_b)
        return (self.app.train_comm_bl + self.app.test_comm_bl) * sl

    def t_aggreg(self, vm_id: str) -> float:
        """Server aggregation time on vm (scaled like any execution).

        Uses the measured-engine hook when configured, else the paper's
        profiled `aggreg_bl` baseline.
        """
        if self.aggreg_time_fn is not None:
            return self.aggreg_time_fn(vm_id)
        return self.app.aggreg_bl * self.env.inst_slowdown(vm_id)

    def t_fold(self, vm_id: str, n_clients: int) -> float:
        """Per-client streaming-fold share of the aggregation time.

        The async round engine folds each c_msg_train as it lands; the
        same total aggregation work (t_aggreg) is split across N folds,
        so each fold costs t_aggreg/N on the server VM."""
        return self.t_aggreg(vm_id) / max(n_clients, 1)

    def async_round_time(self, arrival_offsets: Mapping[str, float], server_vm: str) -> float:
        """Streaming-fold round span (async engine accounting).

        ``arrival_offsets`` maps client -> seconds from dispatch until its
        c_msg_train lands on the server (exec + comm, *without* the
        aggregation term).  Folds serialize on the server and pipeline
        behind arrivals: fold_i starts at max(arrival_i, previous fold
        end).  The barrier protocol's span is max(arrival) + t_aggreg;
        the streaming span is <= that, with equality when every message
        is in before the first fold finishes the queue."""
        t_fold = self.t_fold(server_vm, len(arrival_offsets))
        server_free = 0.0
        for arrival in sorted(arrival_offsets.values()):
            server_free = max(server_free, arrival) + t_fold
        return server_free

    def deadline_round_time(
        self,
        arrival_offsets: Mapping[str, float],
        server_vm: str,
        deadline_s: float,
        carry_in: int = 0,
        min_clients: int = 1,
    ) -> DeadlineRoundPlan:
        """Partial-round (T_round) span accounting for the deadline engine.

        The round closes at the effective deadline — ``deadline_s``
        extended, never shrunk, until at least ``min_clients`` fresh
        messages are in — with whatever subset arrived by then; later
        arrivals carry into the next round.  ``carry_in`` counts the
        previous round's stragglers whose parked messages fold first
        (they sit on the server at dispatch, i.e. arrival 0).  Each fold
        costs ``t_fold`` (t_aggreg split over the full cohort) and folds
        pipeline behind arrivals exactly like `async_round_time`; when
        nobody misses, the round closes at the fold drain (barrier on
        count reached before T_round), otherwise not before the
        effective deadline — a missing message could land until then.
        """
        if not arrival_offsets:
            raise ValueError("deadline_round_time needs at least one client")
        t_fold = self.t_fold(server_vm, len(arrival_offsets))
        order = sorted(arrival_offsets.items(), key=lambda kv: (kv[1], kv[0]))
        effective = float(deadline_s)
        need = min(int(min_clients), len(order))
        if need > 0:
            effective = max(effective, order[need - 1][1])
        on_time = tuple(cid for cid, t in order if t <= effective)
        late = tuple(cid for cid, t in order if t > effective)
        server_free = carry_in * t_fold
        for cid, arrival in order:
            if arrival > effective:
                continue
            server_free = max(server_free, arrival) + t_fold
        span = server_free if not late else max(server_free, effective)
        return DeadlineRoundPlan(
            span_s=span,
            effective_deadline_s=effective,
            on_time=on_time,
            late=late,
        )

    def round_plan(
        self,
        arrival_offsets: Mapping[str, float],
        server_vm: str,
        *,
        async_rounds: bool = False,
        t_round_s: Optional[float] = None,
        carry_in: int = 0,
        min_clients: int = 1,
    ) -> RoundPlan:
        """Unified per-round accounting: pick the barrier (Eq. 16 /
        Algorithm 1), streaming-fold, or T_round-deadline timeline from
        one call — the control-plane round loop's single planning entry.
        """
        if t_round_s is not None and not async_rounds:
            raise ValueError("a round deadline requires async rounds")
        if t_round_s is not None:
            plan = self.deadline_round_time(
                arrival_offsets,
                server_vm,
                t_round_s,
                carry_in=carry_in,
                min_clients=min_clients,
            )
            return RoundPlan(
                span_s=plan.span_s,
                client_times=dict(arrival_offsets),
                deadline=plan,
                policy_deadline_s=float(t_round_s),
            )
        if async_rounds:
            return RoundPlan(
                span_s=self.async_round_time(arrival_offsets, server_vm),
                client_times=dict(arrival_offsets),
            )
        t_aggreg = self.t_aggreg(server_vm)
        client_times = {cid: t + t_aggreg for cid, t in arrival_offsets.items()}
        return RoundPlan(
            span_s=max(client_times.values()), client_times=client_times
        )

    def deadline_from_t_max(self, frac: float = 1.0) -> float:
        """T_round derived from the worst-case round bound (Eq. 7's
        normalizer): any silo slower than ``frac * t_max()`` is
        pathological by the model's own accounting."""
        if frac <= 0.0:
            raise ValueError("frac must be positive")
        return frac * self.t_max()

    def update_message_sizes(self, sizes: MessageSizes) -> None:
        """Replace the app's estimated message sizes with *measured* ones.

        The live socket transport measures each round's serialized
        payloads (`repro.federated.messages.measure_messages` semantics
        on real wire bytes) and feeds them back here through
        `to_cost_model_sizes`, so Eq.-6 communication costs track what
        the run actually moved.  The cached Eq.-7 cost bound depends on
        message volume and is invalidated; t_max does not (it has no
        per-GB term)."""
        self.app = dataclasses.replace(self.app, messages=sizes)
        self._cost_max = None

    def comm_cost(self, client_provider: str, server_provider: str) -> float:
        """Eq. 6: comm_{jm} with j = client's provider, m = server's."""
        m = self.app.messages
        server_out = (m.s_msg_train_gb + m.s_msg_aggreg_gb) * self.env.transfer_cost_gb(
            server_provider
        )
        client_out = (m.c_msg_train_gb + m.c_msg_test_gb) * self.env.transfer_cost_gb(
            client_provider
        )
        return server_out + client_out

    def client_round_time(self, client_id: str, client_vm: str, server_vm: str) -> float:
        """Constraint 16 left-hand side: exec + comm + aggregation."""
        cvm = self.env.vm_types[client_vm]
        svm = self.env.vm_types[server_vm]
        return (
            self.t_exec(client_id, client_vm)
            + self.t_comm(cvm.region, svm.region)
            + self.t_aggreg(server_vm)
        )

    # -- normalization bounds (T_max, cost_max; Eq. 7) -----------------------
    def t_max(self) -> float:
        """Maximum possible makespan over all client/VM/server-VM choices."""
        if self._t_max is None:
            worst = 0.0
            vms = list(self.env.vm_types)
            for c in self.app.clients:
                for cvm in vms:
                    for svm in vms:
                        worst = max(worst, self.client_round_time(c.client_id, cvm, svm))
            self._t_max = worst
        return self._t_max

    def cost_max(self) -> float:
        """Eq. 7."""
        if self._cost_max is None:
            max_rate = max(
                vm.cost_per_second("on_demand") for vm in self.env.vm_types.values()
            )
            providers = list(self.env.providers)
            max_comm = max(
                self.comm_cost(pj, pm) for pj in providers for pm in providers
            )
            n = self.app.n_clients
            self._cost_max = max_rate * self.t_max() * (n + 1) + max_comm * n
        return self._cost_max

    # -- placement evaluation -------------------------------------------------
    def makespan(self, placement: Mapping[str, Assignment]) -> float:
        """Algorithm-1 style makespan: max over clients of round time."""
        server_vm = placement[SERVER].vm_id
        worst = 0.0
        for c in self.app.clients:
            t = self.client_round_time(c.client_id, placement[c.client_id].vm_id, server_vm)
            worst = max(worst, t)
        return worst

    def vm_costs(self, placement: Mapping[str, Assignment], makespan_s: float) -> float:
        """Eq. 4: every allocated VM billed for the whole round makespan."""
        total = 0.0
        for task, a in placement.items():
            vm = self.env.vm_types[a.vm_id]
            total += vm.cost_per_second(a.market) * makespan_s
        return total

    def comm_costs(self, placement: Mapping[str, Assignment]) -> float:
        """Eq. 5: message-exchange cost of every client with the server."""
        server_vm = self.env.vm_types[placement[SERVER].vm_id]
        total = 0.0
        for c in self.app.clients:
            cvm = self.env.vm_types[placement[c.client_id].vm_id]
            total += self.comm_cost(cvm.provider, server_vm.provider)
        return total

    def objective(self, total_costs: float, makespan_s: float) -> float:
        """Eq. 3 normalized: alpha*cost/cost_max + (1-alpha)*t_m/T_max."""
        return (
            self.alpha * (total_costs / self.cost_max())
            + (1.0 - self.alpha) * (makespan_s / self.t_max())
        )

    def evaluate(self, placement: Mapping[str, Assignment]) -> PlacementEvaluation:
        ms = self.makespan(placement)
        vmc = self.vm_costs(placement, ms)
        cc = self.comm_costs(placement)
        total = vmc + cc
        return PlacementEvaluation(
            makespan_s=ms,
            vm_costs=vmc,
            comm_costs=cc,
            total_costs=total,
            objective=self.objective(total, ms),
        )

    # -- resource accounting (constraints 12-15) ------------------------------
    def capacity_ok(self, placement: Mapping[str, Assignment]) -> bool:
        per_provider_gpu: Dict[str, int] = {}
        per_provider_cpu: Dict[str, int] = {}
        per_region_gpu: Dict[str, int] = {}
        per_region_cpu: Dict[str, int] = {}
        for a in placement.values():
            vm = self.env.vm_types[a.vm_id]
            per_provider_gpu[vm.provider] = per_provider_gpu.get(vm.provider, 0) + vm.gpus
            per_provider_cpu[vm.provider] = per_provider_cpu.get(vm.provider, 0) + vm.vcpus
            per_region_gpu[vm.region] = per_region_gpu.get(vm.region, 0) + vm.gpus
            per_region_cpu[vm.region] = per_region_cpu.get(vm.region, 0) + vm.vcpus
        for pid, p in self.env.providers.items():
            if p.max_gpus is not None and per_provider_gpu.get(pid, 0) > p.max_gpus:
                return False
            if p.max_vcpus is not None and per_provider_cpu.get(pid, 0) > p.max_vcpus:
                return False
        for rid, r in self.env.regions.items():
            if r.max_gpus is not None and per_region_gpu.get(rid, 0) > r.max_gpus:
                return False
            if r.max_vcpus is not None and per_region_cpu.get(rid, 0) > r.max_vcpus:
                return False
        return True
