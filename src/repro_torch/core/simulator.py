"""Event-driven simulator of a Multi-FedLS execution (paper §5).

This is the port's own copy of ``repro/core/simulator.py``, which uses no JAX:
the same classes, fields and arithmetic, so both packages' schedulers
make the same decisions.  The port imports nothing of the JAX package;
the text below is the reference's, and its module names point into
that package.

The simulator is one *driver* of the shared control plane
(`repro.core.control_plane.ControlPlane`): it advances a virtual clock
and a billing ledger, while every orchestration decision — Initial
Mapping, §4.3 revocation recovery, §4.4 straggler escalation,
checkpoint bookkeeping — routes through the control plane's Protocol
surfaces and leaves a typed event trace on its bus
(`SimulationResult.trace`).  The live `repro.federated.async_server`
engine drives the same bus with real training; only the clock differs.

The simulator reproduces the paper's experiment grids (Tables 5-8, §5.7):
scenarios {all-spot, on-demand-server + spot-clients, all-on-demand} x
termination rates k_r in {3600, 7200, 14400} x checkpoint policies.

Configuration: prefer the fluent, validated builder ::

    Experiment.on(env).app(app).markets(clients="spot") \
        .revocations(k_r=7200).async_rounds(deadline=900.0).simulate()

``SimulationConfig`` remains as a thin deprecated shim for existing
callers; it now validates its fields in ``__post_init__`` instead of
failing rounds-deep into a run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Set, Tuple, Union

from .application_model import FLApplication
from .autopilot import (
    AutopilotSpec,
    BudgetTracker,
    BudgetedMapper,
    CostAwareScheduler,
    DeadlineController,
    MapperLike,
    PriceTicker,
)
from .cloud_model import CloudEnvironment, VMType
from .control_plane import ControlPlane, SchedulerAPI
from .cost_model import SERVER, Assignment, CostModel, DeadlineRoundPlan, Placement
from .dynamic_scheduler import DynamicScheduler
from .events import Event, EventBus, RevocationOccurred, StragglerEscalated
from .fault_tolerance import (
    CheckpointPolicy,
    FaultToleranceModule,
    RiskAwareCheckpointPolicy,
)
from .initial_mapping import InitialMapping, MappingSolution
from .revocation import RevocationModel, RevocationSampler

# Legacy names: the simulator's event records are the control plane's bus
# events (same fields, same construction order), so traces and the
# result's `events`/`escalations` lists speak one vocabulary.
RevocationEvent = RevocationOccurred
EscalationEvent = StragglerEscalated


@dataclasses.dataclass
class SimulationConfig:
    """Deprecated shim — prefer `repro.core.control_plane.Experiment`.

    Kept so existing callers/tests/benchmarks run unchanged; the fluent
    builder produces exactly this object (see docs/control_plane.md for
    the kwarg -> builder-method migration table).  Fields are validated
    at construction; app-dependent coherence (quorum vs cohort size) is
    re-checked by `validate(app)` at run start / `Experiment.build()`.
    """

    alpha: float = 0.5
    server_market: str = "on_demand"
    client_market: str = "on_demand"
    k_r: Optional[float] = None           # mean seconds between revocation events
    seed: int = 0
    vm_startup_s: float = 154.0           # AWS-like prep time (2:34, §5.4)
    checkpoint: Optional[CheckpointPolicy] = None  # None = checkpointing off
    remove_revoked: bool = True           # Algorithm 3 first line
    n_rounds: Optional[int] = None        # override app.n_rounds
    use_greedy_mapping: bool = False      # use the heuristic instead of MILP
    # The paper's PoC (§5.7) solves the Initial Mapping at on-demand prices
    # and reuses that placement for spot executions ("the instances selected
    # per region are the same as in previous work"). Set to "actual" to
    # optimize with the execution market's prices instead.
    mapping_prices: str = "on_demand"     # "on_demand" | "actual"
    # Optional vm_id -> seconds override for the server aggregation time,
    # e.g. derived from the measured fused-engine bandwidth via
    # repro.federated.agg_engine.make_measured_aggreg_fn. None keeps the
    # paper's profiled aggreg_bl baseline.
    aggreg_time_fn: Optional[Callable[[str], float]] = None
    # Async round engine (repro.federated.async_server): the server folds
    # each c_msg_train as it lands (t_aggreg/N per fold, pipelined behind
    # arrivals) instead of barriering on the slowest silo and then paying
    # the full t_aggreg. False keeps the paper's barrier accounting.
    async_rounds: bool = False
    # Deadline-driven partial rounds (requires async_rounds=True): the
    # round closes at T_round with whatever c_msg_train subset arrived —
    # extended until `deadline_min_clients` fresh silos are in — and late
    # silos carry into the next round's (discounted) average instead of
    # holding the round hostage.  A float is a fixed T_round in seconds; a
    # callable (round_idx, arrival_offsets) -> seconds derives it per
    # round (e.g. a quantile of the offsets, or CostModel.deadline_from_
    # t_max).  None keeps pure barrier-on-count async rounds.
    round_deadline: Optional[Union[float, Callable[[int, Dict[str, float]], float]]] = None
    deadline_min_clients: int = 1
    # Consecutive deadline misses by the same silo before its VM is
    # treated as a §4.4 soft fault and replaced via the Dynamic Scheduler.
    deadline_escalate_after: int = 2
    # Cost autopilot (repro.core.autopilot): price-feed billing, budget-
    # constrained placement/replacement, risk-aware checkpoint cadence,
    # and the adaptive deadline controller.  None keeps the paper's
    # static cost heuristic — and existing traces — exactly.
    autopilot: Optional[AutopilotSpec] = None

    def __post_init__(self) -> None:
        self.validate()

    def validate(self, app: Optional[FLApplication] = None) -> None:
        """Reject incoherent configurations up front.

        Field-local checks run at construction; pass ``app`` (as the
        simulator and `Experiment.build()` do) for the cohort-dependent
        quorum check."""
        if not 0.0 <= self.alpha <= 1.0:
            raise ValueError("alpha must be in [0, 1]")
        for market in (self.server_market, self.client_market):
            if market not in ("on_demand", "spot"):
                raise ValueError(
                    f"market must be 'on_demand' or 'spot', got {market!r}"
                )
        if self.k_r is not None and self.k_r <= 0:
            raise ValueError("k_r must be positive (or None to disable)")
        if self.vm_startup_s < 0:
            raise ValueError("vm_startup_s must be >= 0")
        if self.n_rounds is not None and self.n_rounds < 1:
            raise ValueError("n_rounds must be >= 1")
        if self.mapping_prices not in ("on_demand", "actual"):
            raise ValueError("mapping_prices must be 'on_demand' or 'actual'")
        if self.round_deadline is not None and not self.async_rounds:
            raise ValueError(
                "round_deadline requires async_rounds=True (partial rounds "
                "are a mode of the streaming fold engine)"
            )
        if self.deadline_min_clients < 1:
            raise ValueError("deadline_min_clients must be >= 1")
        if self.deadline_escalate_after < 1:
            raise ValueError("deadline_escalate_after must be >= 1")
        if (
            app is not None
            and self.round_deadline is not None
            and self.deadline_min_clients > app.n_clients
        ):
            raise ValueError(
                f"deadline_min_clients={self.deadline_min_clients} exceeds "
                f"the cohort ({app.n_clients} silos): the quorum can never "
                "be met"
            )
        if self.autopilot is not None:
            if self.autopilot.adaptive_deadline:
                if not self.async_rounds:
                    raise ValueError(
                        "autopilot adaptive_deadline requires "
                        "async_rounds=True (T_round is a mode of the "
                        "streaming fold engine)"
                    )
                if callable(self.round_deadline):
                    raise ValueError(
                        "adaptive_deadline replaces the round_deadline "
                        "callable: pass a float initial T_round (or None "
                        "to bootstrap from the first round's arrivals)"
                    )
            if self.autopilot.risk_checkpointing and self.checkpoint is None:
                raise ValueError(
                    "autopilot risk_checkpointing needs a checkpoint "
                    "policy: its server_interval_rounds is the calm-market "
                    "baseline the cadence scales down from"
                )


@dataclasses.dataclass
class SimulationResult:
    total_time_s: float        # Multi-FedLS wall time (startup + FL)
    fl_exec_time_s: float      # FL execution only
    total_cost: float          # VM-seconds + message egress
    vm_cost: float
    comm_cost: float
    n_revocations: int
    rounds_completed: int
    checkpoint_overhead_s: float
    initial_mapping: MappingSolution
    events: List[RevocationEvent]
    final_placement: Placement
    # Deadline-driven partial rounds (round_deadline set):
    n_deadline_misses: int = 0           # late c_msg_train messages carried over
    carried_folds: int = 0               # stale folds drained into later rounds
    escalations: List[EscalationEvent] = dataclasses.field(default_factory=list)
    # Full control-plane event trace (publication order; `events` and
    # `escalations` are the RevocationOccurred / StragglerEscalated
    # subsets of it).  scripts/trace_dump.py pretty-prints this.
    trace: List[Event] = dataclasses.field(default_factory=list)


class _Allocation:
    """One live VM allocation with its billing meter."""

    def __init__(self, vm_id: str, market: str, start_s: float) -> None:
        self.vm_id = vm_id
        self.market = market
        self.start_s = start_s
        self.end_s: Optional[float] = None


@dataclasses.dataclass
class _RoundWindow:
    """One round attempt on the virtual clock."""

    round_idx: int
    start_s: float
    end_s: float  # extended by background VM replacements
    client_times: Dict[str, float]     # round-relative completion offsets
    arrival_offsets: Dict[str, float]  # exec + comm only (no aggregation)
    deadline: Optional[DeadlineRoundPlan]
    policy_deadline_s: Optional[float]
    lost_late: Set[str] = dataclasses.field(default_factory=set)
    replaced: Set[str] = dataclasses.field(default_factory=set)
    carried_in: List[str] = dataclasses.field(default_factory=list)
    carried_over: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _RunState:
    """Virtual clock, billing ledger, and cross-round carry state."""

    placement: Placement
    allocations: Dict[str, _Allocation]
    now: float
    fl_start: float
    retired: List[_Allocation] = dataclasses.field(default_factory=list)
    next_rev: float = math.inf
    comm_cost: float = 0.0
    ckpt_overhead: float = 0.0
    carry: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    n_deadline_misses: int = 0
    carried_folds: int = 0
    # Autopilot billing meter: with a price feed the VM ledger settles
    # per round (integrating quotes over allocation segments) instead of
    # as one end-of-run lump sum.
    billed_to_s: float = 0.0
    vm_cost_billed: float = 0.0


class MultiCloudSimulator:
    """Simulates one full Multi-FedLS run by driving the control plane."""

    def __init__(
        self,
        env: CloudEnvironment,
        app: FLApplication,
        config: SimulationConfig,
    ) -> None:
        self.env = env
        self.app = app
        self.config = config
        spec = config.autopilot
        self.cost_model = CostModel(
            env, app, config.alpha,
            aggreg_time_fn=config.aggreg_time_fn,
            price_feed=spec.price_feed if spec is not None else None,
        )
        if spec is not None and spec.budget_usd is not None:
            # Budgeted runs rank §4.4 replacements as (vm, market) pairs
            # at current quotes; a billing-only autopilot (just a price
            # feed) keeps the paper's replacement policy so its decisions
            # stay comparable to the static heuristic.
            self.scheduler: SchedulerAPI = CostAwareScheduler(
                self.cost_model,
                price_feed=spec.price_feed,
                spot_fallback_after=spec.spot_fallback_after,
            )
        else:
            self.scheduler = DynamicScheduler(self.cost_model)
        self.control: Optional[ControlPlane] = None  # built per run()
        # Deadline source for _plan_round: the config's float/callable,
        # replaced by DeadlineController.propose under adaptive_deadline.
        self._round_deadline = config.round_deadline
        self._mapper_decides_markets = False
        self.deadline_controller: Optional[DeadlineController] = None
        self.budget_tracker: Optional[BudgetTracker] = None

    # ------------------------------------------------------------------
    # The run loop: plan a round, drive revocations through the control
    # plane, settle deadlines/checkpoints/costs, repeat.  All module
    # interaction happens via ControlPlane's Protocol-typed verbs.
    # ------------------------------------------------------------------
    def run(self) -> SimulationResult:
        cfg = self.config
        cfg.validate(self.app)
        n_rounds = cfg.n_rounds if cfg.n_rounds is not None else self.app.n_rounds
        sampler = RevocationModel(cfg.k_r, cfg.seed).sampler()
        bus = EventBus()
        ticker = self._setup_autopilot(bus, n_rounds)
        cp = self.control = self._build_control_plane(bus, n_rounds)

        mapping = self._solve_initial_mapping(cp)
        st = _RunState(
            placement=dict(mapping.placement),
            allocations={
                task: _Allocation(a.vm_id, a.market, start_s=0.0)
                for task, a in mapping.placement.items()
            },
            now=cfg.vm_startup_s,
            fl_start=cfg.vm_startup_s,
        )
        cp.register_tasks(st.placement)
        st.next_rev = sampler.next_event_after(0.0)

        round_idx = 1
        while round_idx <= n_rounds:
            if ticker is not None:
                # Market moves the run can act on: quotes for the spot
                # VMs it currently occupies, sampled at round boundaries.
                ticker.publish_updates(bus, self._spot_vms(st), st.now, round_idx)
            win = self._plan_round(round_idx, st)
            cp.dispatch_round(
                round_idx, self.app.n_clients, win.start_s,
                # absolute-clock T_round, consistent with every other field
                None if win.policy_deadline_s is None
                else win.start_s + win.policy_deadline_s,
            )
            rewind = self._drive_revocations(win, st, sampler, cp)
            if rewind is not None:
                round_idx = rewind
                continue  # re-enter the (possibly rewound) round

            st.now = win.end_s
            self._publish_round_timeline(win, st, cp)
            if win.deadline is not None:
                self._settle_deadline(win, st, cp)
            overhead = cp.checkpoint_round(round_idx, st.now)
            st.ckpt_overhead += overhead
            st.now += overhead
            st.comm_cost += cp.accrue_cost(
                "comm", self.cost_model.comm_costs(st.placement), st.now, round_idx
            )
            if cfg.autopilot is not None:
                # Per-round settlement instead of the end-of-run lump sum
                # so the budget tracker and deadline controller see $ as
                # it accrues (and billing follows the feed's quotes).
                self._accrue_vm_cost(st, cp, round_idx)
            cp.close_round(round_idx, st.now, win.end_s - win.start_s,
                           carried_over=win.carried_over,
                           carried_in=win.carried_in)
            round_idx += 1

        for alloc in st.allocations.values():
            alloc.end_s = st.now
            st.retired.append(alloc)
        if cfg.autopilot is not None:
            self._accrue_vm_cost(st, cp, n_rounds)
            vm_cost = st.vm_cost_billed
        else:
            vm_cost = self._vm_cost(st)
            cp.accrue_cost("vm", vm_cost, st.now)

        return SimulationResult(
            total_time_s=st.now,
            fl_exec_time_s=st.now - st.fl_start,
            total_cost=vm_cost + st.comm_cost,
            vm_cost=vm_cost,
            comm_cost=st.comm_cost,
            n_revocations=len(cp.revocation_events),
            rounds_completed=n_rounds,
            checkpoint_overhead_s=st.ckpt_overhead,
            initial_mapping=mapping,
            events=cp.revocation_events,
            final_placement=st.placement,
            n_deadline_misses=st.n_deadline_misses,
            carried_folds=st.carried_folds,
            escalations=cp.escalation_events,
            trace=cp.bus.trace,
        )

    # ------------------------------------------------------------------
    def _setup_autopilot(
        self, bus: EventBus, n_rounds: int
    ) -> Optional[PriceTicker]:
        """Build and attach the autopilot's bus subscribers for one run.

        Returns the `PriceTicker` (when a feed is configured) the run
        loop drives at round boundaries; the tracker/controller live on
        ``self`` so callers can inspect them after the run."""
        spec = self.config.autopilot
        if spec is None:
            return None
        if spec.budget_usd is not None:
            tracker = BudgetTracker(spec.budget_usd)
            tracker.attach(bus)
            self.budget_tracker = tracker
            if isinstance(self.scheduler, DynamicScheduler):
                self.scheduler.budget = tracker
        if spec.adaptive_deadline:
            raw = self.config.round_deadline
            initial = float(raw) if isinstance(raw, (int, float)) else None
            allowance = (
                spec.budget_usd / n_rounds
                if spec.budget_usd is not None and n_rounds > 0
                else None
            )
            controller = spec.build_controller(
                initial_t_round_s=initial,
                round_cost_allowance_usd=allowance,
            )
            controller.attach(bus)
            self.deadline_controller = controller
            self._round_deadline = controller.propose
        if spec.price_feed is not None:
            return PriceTicker(spec.price_feed)
        return None

    def _spot_vms(self, st: _RunState) -> List[VMType]:
        return [
            self.env.vm_types[a.vm_id]
            for a in st.allocations.values()
            if a.market == "spot"
        ]

    def _accrue_vm_cost(
        self, st: _RunState, cp: ControlPlane, round_idx: int
    ) -> None:
        """Settle VM billing for [billed_to_s, now] at feed prices."""
        t0, t1 = st.billed_to_s, st.now
        if t1 <= t0:
            return
        total = 0.0
        seen: Set[int] = set()
        for alloc in list(st.allocations.values()) + st.retired:
            if id(alloc) in seen:
                continue  # final settlement sees live allocs in both lists
            seen.add(id(alloc))
            a0 = max(alloc.start_s, t0)
            a1 = min(alloc.end_s if alloc.end_s is not None else t1, t1)
            if a1 > a0:
                total += self.cost_model.vm_cost_between(
                    alloc.vm_id, alloc.market, a0, a1
                )
        st.billed_to_s = t1
        if total:
            st.vm_cost_billed += cp.accrue_cost("vm", total, t1, round_idx)

    # ------------------------------------------------------------------
    def _build_control_plane(self, bus: EventBus, n_rounds: int) -> ControlPlane:
        cfg = self.config
        spec = cfg.autopilot
        policy = cfg.checkpoint or CheckpointPolicy(
            server_interval_rounds=0, client_every_round=False
        )
        if spec is not None and spec.risk_checkpointing:
            assert cfg.checkpoint is not None  # enforced by validate()
            base = cfg.checkpoint
            risk_policy = RiskAwareCheckpointPolicy(
                server_interval_rounds=base.server_interval_rounds,
                client_every_round=base.client_every_round,
                disk_bandwidth_Bps=base.disk_bandwidth_Bps,
                transfer_bandwidth_Bps=base.transfer_bandwidth_Bps,
                min_interval_rounds=spec.min_checkpoint_interval_rounds,
                price_sensitivity=spec.checkpoint_price_sensitivity,
            )
            risk_policy.attach(bus)
            policy = risk_policy
        ft = FaultToleranceModule(
            scheduler=self.scheduler,
            policy=policy,
            checkpoint_bytes=(
                self.app.checkpoint_bytes if cfg.checkpoint is not None else 0
            ),
            vm_startup_s=cfg.vm_startup_s,
            remove_revoked=cfg.remove_revoked,
        )
        mapper: MapperLike = self._build_mapper()
        if spec is not None and spec.budget_usd is not None:
            mapper = BudgetedMapper(
                mapper,
                self.cost_model,
                budget_usd=spec.budget_usd,
                n_rounds=n_rounds,
                k_r=cfg.k_r,
                vm_startup_s=cfg.vm_startup_s,
                bus=bus,
            )
            self._mapper_decides_markets = True
        return ControlPlane(
            fault_tolerance=ft,
            scheduler=self.scheduler,
            mapper=mapper,
            bus=bus,
            escalate_after=cfg.deadline_escalate_after,
        )

    def _build_mapper(self) -> InitialMapping:
        if self.config.mapping_prices == "on_demand":
            solve_server, solve_client = "on_demand", "on_demand"
        else:
            solve_server = self.config.server_market
            solve_client = self.config.client_market
        return InitialMapping(
            self.env,
            self.app,
            alpha=self.config.alpha,
            server_market=solve_server,
            client_market=solve_client,
        )

    def _solve_initial_mapping(self, cp: ControlPlane) -> MappingSolution:
        mapping = cp.solve_mapping(use_greedy=self.config.use_greedy_mapping)
        if self._mapper_decides_markets:
            # The BudgetedMapper already chose per-task markets by
            # revocation-adjusted expected cost under the budget.
            return mapping
        # Execution markets may differ from the solve-time prices.
        mapping.placement = {
            task: Assignment(
                a.vm_id,
                self.config.server_market if task == SERVER else self.config.client_market,
            )
            for task, a in mapping.placement.items()
        }
        return mapping

    # ------------------------------------------------------------------
    def _plan_round(self, round_idx: int, st: _RunState) -> _RoundWindow:
        """Per-round accounting via `CostModel.round_plan` (barrier /
        streaming / deadline timeline, selected by the config)."""
        cfg = self.config
        server_vm = st.placement[SERVER].vm_id
        svm = self.env.vm_types[server_vm]
        offsets: Dict[str, float] = {}
        for c in self.app.clients:
            cvm = self.env.vm_types[st.placement[c.client_id].vm_id]
            offsets[c.client_id] = self.cost_model.t_exec(
                c.client_id, cvm.vm_id
            ) + self.cost_model.t_comm(cvm.region, svm.region)

        t_round: Optional[float] = None
        deadline = self._round_deadline  # controller.propose under autopilot
        if cfg.async_rounds and deadline is not None:
            t_round = (
                deadline(round_idx, dict(offsets))
                if callable(deadline)
                else float(deadline)
            )
        plan = self.cost_model.round_plan(
            offsets,
            server_vm,
            async_rounds=cfg.async_rounds,
            t_round_s=t_round,
            carry_in=len(st.carry),
            min_clients=cfg.deadline_min_clients,
        )
        return _RoundWindow(
            round_idx=round_idx,
            start_s=st.now,
            end_s=st.now + plan.span_s,
            client_times=plan.client_times,
            arrival_offsets=offsets,
            deadline=plan.deadline,
            policy_deadline_s=plan.policy_deadline_s,
        )

    # ------------------------------------------------------------------
    def _drive_revocations(
        self,
        win: _RoundWindow,
        st: _RunState,
        sampler: RevocationSampler,
        cp: ControlPlane,
    ) -> Optional[int]:
        """Process Poisson revocations inside the round window.

        Returns None when the round completes, else the round index to
        re-enter (the same round for a client fault, the checkpoint's
        resume round for a server fault)."""
        while st.next_rev <= win.end_s:
            t_rev = st.next_rev
            st.next_rev = sampler.next_event_after(t_rev)
            spot_tasks = sorted(
                task for task, a in st.placement.items() if a.market == "spot"
            )
            victim = sampler.pick_victim(spot_tasks)
            if victim is None:
                continue
            old_vm = st.allocations[victim].vm_id

            is_late = win.deadline is not None and victim in win.deadline.late
            delivered = (
                victim != SERVER
                and t_rev >= win.start_s + win.client_times[victim]
            )
            # The round is not waiting on an already-delivered or
            # deadline-cut client: replace it in the background; the
            # round result stands but the next round cannot start before
            # the new VM is ready.  A late client revoked before
            # delivery loses its in-flight update: nothing to carry.
            background = victim != SERVER and (delivered or is_late)
            outcome = cp.revocation(
                victim, st.placement, old_vm, t_rev, win.round_idx,
                interrupted=not background,
            )
            self._swap_allocation(st, victim, outcome.plan.decision.new_vm, t_rev)
            if background:
                if is_late and not delivered:
                    win.lost_late.add(victim)
                win.replaced.add(victim)
                win.end_s = max(win.end_s, t_rev + outcome.delay_s)
                continue

            if victim == SERVER:
                # Weights recovered from the freshest checkpoint; rounds
                # after the checkpoint are lost and re-executed.
                next_round = max(1, outcome.plan.resume_round)
            else:
                # The interrupted client redoes the current round; the
                # server re-sends the weights (extra s_msg_train egress).
                next_round = win.round_idx
                svm = self.env.vm_types[st.placement[SERVER].vm_id]
                st.comm_cost += cp.accrue_cost(
                    "resend",
                    self.app.messages.s_msg_train_gb
                    * self.env.transfer_cost_gb(svm.provider),
                    t_rev,
                    win.round_idx,
                )
            st.now = t_rev + outcome.delay_s
            return next_round
        return None

    # ------------------------------------------------------------------
    def _publish_round_timeline(
        self, win: _RoundWindow, st: _RunState, cp: ControlPlane
    ) -> None:
        """Emit the completed round's arrival/fold events.

        Interrupted round attempts publish no timeline (they re-run);
        per completed round the trace satisfies: every UpdateArrived is
        matched by exactly one fresh UpdateFolded *or* an entry in the
        round's carried_over set, and last round's carry drains first as
        stale folds — the invariant tests/test_control_plane.py pins.

        The simulator models unit example weights and no staleness
        discount (its round accounting treats a carried fold as a full
        fold), so every UpdateFolded here carries weight ==
        folded_weight == 1.0; staleness is marked by origin_round.  Only
        the live engine's trace carries real weights and the
        carry_discount."""
        late = set(win.deadline.late) if win.deadline is not None else set()
        for task, origin in st.carry:
            # Parked messages already sit on the server at dispatch.
            cp.update_folded(win.round_idx, task, win.start_s,
                             origin_round=origin)
        order = sorted(win.arrival_offsets.items(), key=lambda kv: (kv[1], kv[0]))
        for task, offset in order:
            if task in win.lost_late:
                continue  # revoked before delivery: the message never landed
            cp.update_arrived(win.round_idx, task, win.start_s + offset)
            if task not in late:
                cp.update_folded(win.round_idx, task, win.start_s + offset)

    # ------------------------------------------------------------------
    def _settle_deadline(
        self, win: _RoundWindow, st: _RunState, cp: ControlPlane
    ) -> None:
        """End-of-round carry-over bookkeeping and §4.4 escalation.

        Last round's parked messages were folded this round; this
        round's late silos take their place in the buffer — minus any
        whose VM was revoked pre-delivery (update lost; the revocation
        already replaced the VM, so no miss streak either)."""
        deadline = win.deadline
        assert deadline is not None
        st.carried_folds += len(st.carry)
        st.n_deadline_misses += len(deadline.late)
        win.carried_in = [task for task, _ in st.carry]
        policy_t = (
            win.policy_deadline_s
            if win.policy_deadline_s is not None
            else deadline.effective_deadline_s
        )
        # deadline_s fields are published on the publisher's clock (the
        # simulator's absolute virtual clock), like every other event
        # field — DeadlineRoundPlan's times are dispatch-relative, so
        # rebase onto the round start.
        cp.deadline_expired(  # clears on-time miss streaks
            win.round_idx, st.now,
            win.start_s + deadline.effective_deadline_s,
            win.start_s + policy_t,
            deadline.on_time, deadline.late,
        )
        for task in win.lost_late:
            cp.clear_streak(task)

        new_carry = [
            (task, win.round_idx)
            for task in deadline.late
            if task not in win.lost_late
        ]
        for task, _ in new_carry:
            if task in win.replaced:
                # A revocation already provisioned this silo a fresh VM
                # mid-round; escalating at round end would replace the
                # replacement.  The delivered-late message still carries,
                # but the slow-VM evidence is gone.
                cp.clear_streak(task)
                continue
            streak = cp.record_miss(task)
            if streak is not None:
                # §4.4 soft fault: replace the chronically slow VM via
                # the Dynamic Scheduler.  The swap runs in the
                # background, but the silo cannot train the next round
                # before its replacement is up.
                old_vm = st.allocations[task].vm_id
                outcome = cp.escalate(
                    task, st.placement, old_vm, win.end_s, win.round_idx, streak
                )
                self._swap_allocation(
                    st, task, outcome.plan.decision.new_vm, win.end_s
                )
                st.now = max(st.now, win.end_s + outcome.delay_s)
        st.carry = new_carry
        win.carried_over = [task for task, _ in new_carry]

    # ------------------------------------------------------------------
    def _swap_allocation(
        self, st: _RunState, task: str, new_vm: str, swap_time_s: float
    ) -> None:
        old = st.allocations[task]
        old.end_s = swap_time_s
        st.retired.append(old)
        market = st.placement[task].market
        st.placement[task] = Assignment(new_vm, market)
        st.allocations[task] = _Allocation(new_vm, market, start_s=swap_time_s)

    def _vm_cost(self, st: _RunState) -> float:
        total = 0.0
        for alloc in st.retired:
            vm = self.env.vm_types[alloc.vm_id]
            end = alloc.end_s if alloc.end_s is not None else st.now
            total += vm.cost_per_second(alloc.market) * max(0.0, end - alloc.start_s)
        return total
