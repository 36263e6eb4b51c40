"""Multi-FedLS control plane: module Protocols, shared orchestration, and
the fluent :class:`Experiment` builder.
This is the port's own copy of ``repro/core/control_plane.py``: the same
Protocols, control plane and builder, so a chain built on either package
validates, simulates and traces alike.  The builder's serve targets and
its aggregation, hierarchy, chaos and transport settings reach this
package's ``federated`` modules (:mod:`repro_torch.federated`), whose
servers hold their weights on the card unless ``serve(..., device=...)``
asks for another device.  The port imports nothing of the JAX package.


The paper (Fig. 1/§4) defines Multi-FedLS as four cooperating modules.
This module turns that prose architecture into code-level contracts:

* **Protocols** — :class:`PreSchedulerAPI`, :class:`MapperAPI`,
  :class:`FaultToleranceAPI`, :class:`SchedulerAPI` are the *only*
  surfaces the orchestration layer is allowed to touch.  The concrete
  classes (`PreScheduling`, `InitialMapping`, `FaultToleranceModule`,
  `DynamicScheduler`) implement them structurally; swapping any module
  for a cost-aware or facility-specific policy (FedCostAware-style) is
  a constructor argument, not a fork of the engine.

* **ControlPlane** — binds the modules to a typed
  :class:`~repro_torch.core.events.EventBus` and owns the orchestration
  decisions that used to be duplicated between the virtual-clock
  simulator and the live async server: revocation recovery
  (§4.3), deadline-miss streak tracking and §4.4 straggler escalation
  (:class:`StragglerTracker`), checkpoint bookkeeping, and the event
  trace itself.

* **Experiment** — a fluent, validated builder that replaces raw
  ``SimulationConfig(...)`` construction.  Incoherent combinations
  (a ``round_deadline`` without ``async_rounds``, a quorum larger than
  the cohort) are rejected at *build* time instead of rounds-deep into
  a run, and the same chain drives both the simulator
  (:meth:`Experiment.simulate`) and the live engine
  (:meth:`Experiment.serve`).

``SimulationConfig`` remains as a thin deprecated shim — see
``docs/control_plane.md`` for the kwarg -> builder migration table.
"""
from __future__ import annotations

import dataclasses
from typing import (
    TYPE_CHECKING,
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Protocol,
    Sequence,
    Set,
    Tuple,
    Union,
    cast,
    runtime_checkable,
)

from .cost_model import Assignment, Placement
from .dynamic_scheduler import ReplacementDecision
from .events import (
    CheckpointSaved,
    CostAccrued,
    DeadlineExpired,
    Event,
    EventBus,
    PartialFolded,
    RecoveryCompleted,
    RegionClosed,
    RevocationOccurred,
    RoundClosed,
    RoundDispatched,
    StragglerEscalated,
    UpdateArrived,
    UpdateFolded,
    VMReplaced,
)
from .fault_tolerance import CheckpointPolicy, RecoveryPlan
from .initial_mapping import MappingSolution
from .pre_scheduling import PreSchedulingResult

if TYPE_CHECKING:  # concrete types only needed for static conformance
    from .application_model import FLApplication
    from .autopilot import AutopilotSpec
    from .cloud_model import CloudEnvironment, PriceFeed
    from .dynamic_scheduler import DynamicScheduler
    from .fault_tolerance import FaultToleranceModule
    from .initial_mapping import InitialMapping
    from .pre_scheduling import PreScheduling
    from .simulator import SimulationConfig, SimulationResult
    from ..federated.hierarchy import HierarchyCoordinator

__all__ = [
    "ControlPlane",
    "Experiment",
    "FaultToleranceAPI",
    "HierarchyAPI",
    "MapperAPI",
    "PreSchedulerAPI",
    "RecoveryOutcome",
    "SchedulerAPI",
    "StragglerTracker",
]


# ---------------------------------------------------------------------------
# Module protocols (the paper's Fig. 1 boxes as typing.Protocol surfaces)
# ---------------------------------------------------------------------------

@runtime_checkable
class PreSchedulerAPI(Protocol):
    """§4.1 Pre-Scheduling: probe the environment, derive slowdowns."""

    def run(
        self,
        baseline_vm: str,
        baseline_pair: Tuple[str, str],
        n_repeats: int = ...,
    ) -> PreSchedulingResult: ...

    def attach_to_environment(self, result: PreSchedulingResult) -> None: ...


@runtime_checkable
class MapperAPI(Protocol):
    """§4.2 Initial Mapping: place the server and every silo."""

    def solve(self) -> MappingSolution: ...

    def solve_greedy(self) -> MappingSolution: ...


@runtime_checkable
class FaultToleranceAPI(Protocol):
    """§4.3 Fault Tolerance: monitoring, checkpoints, recovery plans."""

    def register_tasks(self, placement: Mapping[str, Assignment]) -> None: ...

    def on_round_complete(self, round_idx: int, now_s: float) -> float: ...

    def handle_fault(
        self,
        faulty_task: str,
        current_placement: Placement,
        revoked_vm: str,
        now_s: float,
        current_round: int,
    ) -> RecoveryPlan: ...

    def handle_straggler(
        self,
        slow_task: str,
        current_placement: Placement,
        slow_vm: str,
        now_s: float,
        current_round: int,
    ) -> RecoveryPlan: ...

    def recovery_delay_s(self, plan: RecoveryPlan) -> float: ...


@runtime_checkable
class SchedulerAPI(Protocol):
    """§4.4 Dynamic Scheduler: replacement-instance selection."""

    def candidate_set(self, task: str, now_s: float = ...) -> Set[str]: ...

    def select_instance(
        self,
        faulty_task: str,
        current_map: Mapping[str, Assignment],
        revoked_vm: str,
        remove_revoked: bool = ...,
        candidate_override: Optional[Iterable[str]] = ...,
        now_s: float = ...,
    ) -> ReplacementDecision: ...


@runtime_checkable
class HierarchyAPI(Protocol):
    """Two-level aggregation: regional cohort folds composed via partial
    sums (see :mod:`repro_torch.federated.hierarchy` for the concrete
    coordinator and the numerical-equivalence contract)."""

    @property
    def region_ids(self) -> List[str]: ...

    def cohort_for(
        self, round_idx: int, client_ids: Sequence[str]
    ) -> List[str]: ...

    def fold_partials(
        self,
        round_idx: int,
        partials: Sequence[Any],
        base_params: Any,
        now_s: float = ...,
    ) -> Any: ...

    def fold_round(
        self,
        round_idx: int,
        results: Sequence[Any],
        schedule: Any = ...,
        base_params: Any = ...,
    ) -> Any: ...


def _static_conformance(
    pre: "PreScheduling",
    mapper: "InitialMapping",
    ft: "FaultToleranceModule",
    sched: "DynamicScheduler",
) -> Tuple[PreSchedulerAPI, MapperAPI, FaultToleranceAPI, SchedulerAPI]:
    """mypy-only witness: the concrete modules satisfy their Protocols.

    This function is never called; it exists so `mypy --strict` fails
    the CI typecheck job the moment a concrete module drifts off its
    Protocol surface."""
    return pre, mapper, ft, sched


def _static_hierarchy_conformance(
    coordinator: "HierarchyCoordinator",
) -> HierarchyAPI:
    """mypy-only witness (same contract as :func:`_static_conformance`):
    the concrete hierarchy coordinator satisfies :class:`HierarchyAPI`."""
    return coordinator


# ---------------------------------------------------------------------------
# Shared straggler policy (§4.4 soft faults)
# ---------------------------------------------------------------------------

class StragglerTracker:
    """Consecutive deadline-miss streaks with an escalation threshold.

    The same policy object serves the simulator's round settlement and
    the live engine's fold loop: a miss advances the silo's streak; at
    ``escalate_after`` the tracker reports the streak (the caller
    escalates to the Dynamic Scheduler) and resets it; an on-time
    delivery — or a revocation that already replaced the VM, destroying
    the slow-VM evidence — clears it."""

    def __init__(self, escalate_after: int = 2) -> None:
        if escalate_after < 1:
            raise ValueError("escalate_after must be >= 1")
        self.escalate_after = escalate_after
        self._streak: Dict[str, int] = {}

    def record_miss(self, task: str) -> Optional[int]:
        """Advance ``task``'s streak; return it if escalation is due
        (resetting the streak), else None."""
        streak = self._streak.get(task, 0) + 1
        if streak >= self.escalate_after:
            self._streak[task] = 0
            return streak
        self._streak[task] = streak
        return None

    def clear(self, task: str) -> None:
        self._streak[task] = 0

    def streak_of(self, task: str) -> int:
        return self._streak.get(task, 0)


# ---------------------------------------------------------------------------
# Control plane
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecoveryOutcome:
    """One fault's resolution: the published event, the FT module's plan,
    and the wall-clock delay before the task runs again."""

    event: Event
    plan: RecoveryPlan
    delay_s: float


class ControlPlane:
    """Binds the four Multi-FedLS modules to a typed event bus.

    Drivers (the virtual-clock simulator, the live async server) call
    the verbs below instead of wiring the modules together themselves;
    every decision leaves a typed event on :attr:`bus`.  Modules are
    accepted *only* through their Protocol surfaces — a custom mapper or
    fault-tolerance policy plugs in without touching the drivers.
    """

    def __init__(
        self,
        *,
        fault_tolerance: FaultToleranceAPI,
        scheduler: SchedulerAPI,
        mapper: Optional[MapperAPI] = None,
        pre_scheduler: Optional[PreSchedulerAPI] = None,
        bus: Optional[EventBus] = None,
        escalate_after: int = 2,
    ) -> None:
        if not isinstance(fault_tolerance, FaultToleranceAPI):
            raise TypeError(
                "fault_tolerance does not implement FaultToleranceAPI: "
                f"got {type(fault_tolerance).__name__}"
            )
        if not isinstance(scheduler, SchedulerAPI):
            raise TypeError(
                "scheduler does not implement SchedulerAPI: "
                f"got {type(scheduler).__name__}"
            )
        if mapper is not None and not isinstance(mapper, MapperAPI):
            raise TypeError(
                f"mapper does not implement MapperAPI: got {type(mapper).__name__}"
            )
        if pre_scheduler is not None and not isinstance(
            pre_scheduler, PreSchedulerAPI
        ):
            raise TypeError(
                "pre_scheduler does not implement PreSchedulerAPI: "
                f"got {type(pre_scheduler).__name__}"
            )
        self.ft = fault_tolerance
        self.scheduler = scheduler
        self.mapper = mapper
        self.pre_scheduler = pre_scheduler
        self.bus = bus if bus is not None else EventBus()
        self.stragglers = StragglerTracker(escalate_after)

    # -- initial mapping ---------------------------------------------------
    def solve_mapping(self, use_greedy: bool = False) -> MappingSolution:
        if self.mapper is None:
            raise RuntimeError("ControlPlane was built without a mapper")
        return self.mapper.solve_greedy() if use_greedy else self.mapper.solve()

    def register_tasks(self, placement: Mapping[str, Assignment]) -> None:
        self.ft.register_tasks(placement)

    # -- round lifecycle ---------------------------------------------------
    def dispatch_round(
        self,
        round_idx: int,
        n_clients: int,
        now_s: float,
        deadline_s: Optional[float] = None,
    ) -> RoundDispatched:
        return self.bus.publish(
            RoundDispatched(now_s, round_idx, n_clients, deadline_s)
        )

    def update_arrived(
        self, round_idx: int, task: str, now_s: float, attempt: int = 1
    ) -> UpdateArrived:
        return self.bus.publish(UpdateArrived(now_s, round_idx, task, attempt))

    def update_folded(
        self,
        round_idx: int,
        task: str,
        now_s: float,
        weight: float = 1.0,
        folded_weight: Optional[float] = None,
        origin_round: Optional[int] = None,
    ) -> UpdateFolded:
        fw = folded_weight if folded_weight is not None else weight
        return self.bus.publish(
            UpdateFolded(now_s, round_idx, task, weight, fw, origin_round)
        )

    def close_round(
        self,
        round_idx: int,
        now_s: float,
        span_s: float,
        carried_over: Sequence[str] = (),
        carried_in: Sequence[str] = (),
    ) -> RoundClosed:
        return self.bus.publish(
            RoundClosed(now_s, round_idx, span_s,
                        tuple(carried_over), tuple(carried_in))
        )

    # -- hierarchy (regional partial-sum folds) ----------------------------
    def close_region(
        self,
        round_idx: int,
        region: str,
        now_s: float,
        span_s: float,
        n_folded: int = 0,
        carried_over: Sequence[str] = (),
    ) -> RegionClosed:
        """A region's cohort fold finished; its partial sum is exported."""
        return self.bus.publish(
            RegionClosed(now_s, round_idx, region, span_s,
                         n_folded, tuple(carried_over))
        )

    def partial_folded(
        self,
        round_idx: int,
        region: str,
        n_clients: int,
        weight: float,
        now_s: float,
        base_round: Optional[int] = None,
    ) -> PartialFolded:
        """A regional partial sum entered the parent round's accumulator."""
        return self.bus.publish(
            PartialFolded(now_s, round_idx, region,
                          int(n_clients), float(weight), base_round)
        )

    # -- §4.3 / §4.4 fault recovery ---------------------------------------
    def _complete_recovery(
        self,
        event: Event,
        plan: RecoveryPlan,
        task: str,
        old_vm: str,
        now_s: float,
        reason: str,
    ) -> RecoveryOutcome:
        """Shared tail of every fault: one VMReplaced + RecoveryCompleted
        sequence, so hard (revocation) and soft (straggler) faults can
        never drift apart in the trace vocabulary."""
        delay = self.ft.recovery_delay_s(plan)
        self.bus.publish(
            VMReplaced(now_s, task, old_vm, plan.decision.new_vm,
                       plan.decision.market, reason)
        )
        restored = plan.restore_from.location if plan.restore_from else "none"
        self.bus.publish(
            RecoveryCompleted(now_s + delay, task, plan.resume_round,
                              delay, restored)
        )
        return RecoveryOutcome(event=event, plan=plan, delay_s=delay)

    def revocation(
        self,
        task: str,
        placement: Placement,
        old_vm: str,
        now_s: float,
        round_idx: int,
        interrupted: bool,
    ) -> RecoveryOutcome:
        """§4.3 hard fault: ask the FT module for a recovery plan (which
        routes through the Dynamic Scheduler), publish the trace."""
        plan = self.ft.handle_fault(task, placement, old_vm, now_s, round_idx)
        event = self.bus.publish(
            RevocationOccurred(now_s, task, old_vm, plan.decision.new_vm,
                               round_idx, interrupted)
        )
        return self._complete_recovery(event, plan, task, old_vm, now_s,
                                       "revocation")

    # -- deadline settlement + §4.4 escalation -----------------------------
    def deadline_expired(
        self,
        round_idx: int,
        now_s: float,
        deadline_s: float,
        policy_deadline_s: float,
        on_time: Sequence[str],
        late: Sequence[str],
    ) -> DeadlineExpired:
        for task in on_time:
            self.stragglers.clear(task)
        return self.bus.publish(
            DeadlineExpired(now_s, round_idx, float(deadline_s),
                            float(policy_deadline_s),
                            tuple(on_time), tuple(late))
        )

    def record_miss(self, task: str) -> Optional[int]:
        """Advance the silo's miss streak; a non-None return means the
        caller must escalate (the streak is already reset)."""
        return self.stragglers.record_miss(task)

    def clear_streak(self, task: str) -> None:
        self.stragglers.clear(task)

    def escalate(
        self,
        task: str,
        placement: Placement,
        old_vm: str,
        now_s: float,
        round_idx: int,
        consecutive_misses: int,
    ) -> RecoveryOutcome:
        """§4.4 soft fault: replace a chronically slow silo's VM."""
        plan = self.ft.handle_straggler(task, placement, old_vm, now_s, round_idx)
        event = self.bus.publish(
            StragglerEscalated(now_s, task, old_vm, plan.decision.new_vm,
                               round_idx, consecutive_misses)
        )
        return self._complete_recovery(event, plan, task, old_vm, now_s,
                                       "straggler")

    # -- checkpoints & costs ----------------------------------------------
    def checkpoint_round(self, round_idx: int, now_s: float) -> float:
        """Run the FT module's per-round checkpoint bookkeeping; returns
        (and publishes) the synchronous overhead charged to the round."""
        overhead = self.ft.on_round_complete(round_idx, now_s)
        if overhead > 0.0:
            self.bus.publish(
                CheckpointSaved(now_s, round_idx, "policy", overhead)
            )
        return overhead

    def accrue_cost(
        self, kind: str, amount: float, now_s: float, round_idx: int = 0
    ) -> float:
        if amount != 0.0:
            self.bus.publish(CostAccrued(now_s, kind, amount, round_idx))
        return amount

    # -- trace views -------------------------------------------------------
    @property
    def revocation_events(self) -> List[RevocationOccurred]:
        return cast(
            List[RevocationOccurred], self.bus.events_of(RevocationOccurred)
        )

    @property
    def escalation_events(self) -> List[StragglerEscalated]:
        return cast(
            List[StragglerEscalated], self.bus.events_of(StragglerEscalated)
        )


# ---------------------------------------------------------------------------
# Fluent experiment builder
# ---------------------------------------------------------------------------

DeadlineSpec = Union[float, Callable[[int, Dict[str, float]], float], Any]


class Experiment:
    """Fluent, validated builder for Multi-FedLS runs.

    Example (the paper's on-demand-server / spot-clients scenario with
    T_round partial rounds)::

        result = (Experiment.on(env).app(app)
                  .markets(server="on_demand", clients="spot")
                  .revocations(k_r=7200, seed=3)
                  .checkpoints(every=10)
                  .async_rounds(deadline=900.0, min_clients=4,
                                escalate_after=2)
                  .simulate())

    Every method returns a *new* builder (chains never alias).
    Cross-field coherence rules that only the builder can see (a
    deadline without async rounds, a quorum without a deadline,
    live-only knobs) are rejected in the setters; field-local
    validation (markets, alpha, k_r, ...) lives in ONE place —
    ``SimulationConfig.validate()`` — which :meth:`build` runs via the
    shim's ``__post_init__`` plus the app-aware ``validate(app)``.
    ``build()`` produces a plain validated ``SimulationConfig`` — the
    legacy shim — so the simulator path is byte-identical to a
    hand-built config.  :meth:`serve` builds the matching live
    ``AsyncFLServer`` from the same chain.
    """

    def __init__(
        self,
        env: Optional["CloudEnvironment"] = None,
        app: Optional["FLApplication"] = None,
    ) -> None:
        self._env = env
        self._app = app
        self._overrides: Dict[str, Any] = {}
        self._deadline: Optional[DeadlineSpec] = None
        self._min_clients: Optional[int] = None
        self._carry_discount: float = 0.5
        self._transport: Optional[Dict[str, Any]] = None
        self._chaos: Optional[Any] = None
        self._compression: Optional[Any] = None
        self._schema: Optional[Any] = None
        self._hierarchy: Optional[Dict[str, Any]] = None
        self._autopilot: Optional["AutopilotSpec"] = None

    # -- construction ------------------------------------------------------
    @classmethod
    def on(cls, env: "CloudEnvironment") -> "Experiment":
        """Start a chain on a cloud environment (§3 environment model)."""
        return cls(env=env)

    def _clone(self, **changes: Any) -> "Experiment":
        exp = Experiment(self._env, self._app)
        exp._overrides = dict(self._overrides)
        exp._deadline = self._deadline
        exp._min_clients = self._min_clients
        exp._carry_discount = self._carry_discount
        exp._transport = None if self._transport is None else dict(self._transport)
        exp._chaos = self._chaos
        exp._compression = self._compression
        exp._schema = self._schema
        exp._hierarchy = None if self._hierarchy is None else dict(self._hierarchy)
        exp._autopilot = self._autopilot
        for key, value in changes.items():
            setattr(exp, key, value)
        return exp

    def _set(self, **config_fields: Any) -> "Experiment":
        exp = self._clone()
        exp._overrides.update(config_fields)
        return exp

    # -- fluent setters ----------------------------------------------------
    def app(self, app: "FLApplication") -> "Experiment":
        """Bind the FL application (§3 application model)."""
        return self._clone(_app=app)

    def rounds(self, n: int) -> "Experiment":
        return self._set(n_rounds=int(n))

    def objective(self, alpha: float) -> "Experiment":
        """Cost/makespan trade-off weight (Eq. 3's alpha)."""
        return self._set(alpha=float(alpha))

    def markets(
        self, server: str = "on_demand", clients: str = "on_demand"
    ) -> "Experiment":
        return self._set(server_market=server, client_market=clients)

    def revocations(
        self,
        k_r: Optional[float] = None,
        seed: int = 0,
        remove_revoked: bool = True,
    ) -> "Experiment":
        """Poisson spot-revocation process (§5.6): mean seconds between
        events; None disables revocations."""
        return self._set(k_r=k_r, seed=int(seed), remove_revoked=remove_revoked)

    def startup(self, vm_startup_s: float) -> "Experiment":
        return self._set(vm_startup_s=float(vm_startup_s))

    def checkpoints(
        self,
        policy: Optional[CheckpointPolicy] = None,
        *,
        every: Optional[int] = None,
        client_every_round: bool = True,
    ) -> "Experiment":
        """§4.3 checkpointing: pass a :class:`CheckpointPolicy`, or the
        ``every=N`` shorthand for server-checkpoint-every-N-rounds."""
        if (policy is None) == (every is None):
            raise ValueError("pass exactly one of policy= or every=")
        if policy is None:
            if every is not None and every < 1:
                raise ValueError("every must be >= 1")
            policy = CheckpointPolicy(
                server_interval_rounds=int(every or 0),
                client_every_round=client_every_round,
            )
        return self._set(checkpoint=policy)

    def mapping(
        self, greedy: bool = False, prices: str = "on_demand"
    ) -> "Experiment":
        """§4.2 Initial Mapping solver choice and solve-time prices
        ("on_demand" | "actual")."""
        return self._set(use_greedy_mapping=greedy, mapping_prices=prices)

    def aggregation(
        self,
        aggreg_time_fn: Optional[Callable[[str], float]] = None,
        *,
        compression: Any = None,
        schema: Any = None,
    ) -> "Experiment":
        """Aggregation-path knobs.

        ``aggreg_time_fn`` is the measured-engine hook for the server
        aggregation time (e.g.
        ``repro_torch.federated.agg_engine.make_measured_aggreg_fn``).

        ``compression`` turns on the compressed c_msg_train wire path on
        the *serve* targets: ``"int8"``, ``"fp16"``, ``"topk"`` /
        ``"topk:0.05"``, or a
        :class:`~repro_torch.federated.compression.CompressionSpec`.  Clients
        encode quantized/sparsified deltas (with error feedback), the
        server folds them through the fused dequantize-and-fold path,
        and round message logs carry wire vs dense bytes.  The knob is
        validated here — a bad codec string fails at chain-building
        time, not mid-run — and, like :meth:`chaos`, rejected by the
        simulator target (:meth:`build`), which models message sizes
        rather than carrying real payloads.

        ``schema`` turns on *structured* updates: an
        :class:`~repro_torch.federated.agg_engine.UpdateSchema` or a
        ``{group_name: selector}`` mapping naming the parameter groups
        clients ship (e.g. ``{"adapters": ".lora_"}`` for federated
        LoRA).  Updates carry only the named groups, folds normalize
        weights per group, and round message logs gain per-group byte
        maps; combine with ``compression`` for per-group compressed
        deltas.  Validated at chain time and honoured by all three
        serve drivers (flat async, hierarchy, live transport)."""
        exp = self
        if aggreg_time_fn is not None:
            exp = exp._set(aggreg_time_fn=aggreg_time_fn)
        if compression is not None:
            from ..federated.compression import parse_compression

            exp = exp._clone(_compression=parse_compression(compression))
        if schema is not None:
            from ..federated.agg_engine import as_update_schema

            exp = exp._clone(_schema=as_update_schema(schema))
        return exp if exp is not self else self._clone()

    def async_rounds(
        self,
        enabled: bool = True,
        *,
        deadline: Optional[DeadlineSpec] = None,
        min_clients: Optional[int] = None,
        escalate_after: int = 2,
        carry_discount: float = 0.5,
    ) -> "Experiment":
        """Streaming-fold rounds; optionally deadline-driven (T_round).

        ``deadline`` accepts a fixed T_round in seconds, a
        ``(round_idx, {client: arrival_s}) -> seconds`` callable, or a
        live-engine ``RoundDeadline`` policy — the builder adapts it to
        whichever target (:meth:`simulate` / :meth:`serve`) runs it.

        Only coherence rules the builder alone can see are checked here
        (field ranges are validated downstream: the shim's validate()
        on build(), the engine/tracker constructors on serve()).
        """
        if not enabled and deadline is not None:
            raise ValueError(
                "a round deadline requires async rounds: partial rounds "
                "are a mode of the streaming fold engine"
            )
        if min_clients is not None and deadline is None:
            raise ValueError(
                "min_clients is a deadline quorum: pass deadline= too "
                "(without one, rounds barrier on the full count and the "
                "quorum would be silently ignored)"
            )
        if not 0.0 <= carry_discount <= 1.0:
            raise ValueError("carry_discount must be in [0, 1]")
        exp = self._set(
            async_rounds=enabled,
            deadline_escalate_after=int(escalate_after),
        )
        exp._deadline = deadline if enabled else None
        exp._min_clients = min_clients
        exp._carry_discount = float(carry_discount)
        return exp

    def autopilot(
        self,
        budget: Optional[float] = None,
        *,
        price_feed: Optional["PriceFeed"] = None,
        adaptive_deadline: bool = False,
        risk_checkpointing: bool = False,
        **knobs: Any,
    ) -> "Experiment":
        """Cost autopilot (``repro_torch.core.autopilot``): close the loop on $.

        Four composable features, validated together at chain time:

        * ``budget=`` — a $ ceiling for the run.  The Initial Mapping
          picks per-task markets by revocation-adjusted expected cost
          under it (`BudgetedMapper`), §4.4 replacements rank (vm,
          market) pairs with the accrued spend tilting Eq. 3 toward
          cost (`CostAwareScheduler`), and a `BudgetTracker` on the bus
          publishes ``BudgetExceeded`` when the ledger crosses.
        * ``price_feed=`` — a :class:`~repro_torch.core.cloud_model.PriceFeed`
          (e.g. `SyntheticSpotFeed`, or `TracePriceFeed` replaying a
          dumped `SpotPriceTrace`) makes spot quotes move: billing
          integrates the walk, and ``PriceUpdated`` ticks land on the
          bus.  Simulator target only (the live engine bills nothing).
        * ``adaptive_deadline=True`` — a `DeadlineController` retunes
          T_round online from arrival quantiles, carry-over pressure,
          and $/round, emitting ``DeadlineAdjusted``.  Works on both
          targets: the chain's float deadline (if any) seeds the
          controller, which otherwise bootstraps from the first round's
          arrivals.
        * ``risk_checkpointing=True`` — the chain's checkpoint policy
          becomes a `RiskAwareCheckpointPolicy`: its interval is the
          calm baseline, scaled down as observed revocations cluster or
          spot quotes run hot.  Simulator target only.

        Extra ``knobs`` are forwarded to
        :class:`~repro_torch.core.autopilot.AutopilotSpec` (controller gains,
        clamps, checkpoint cadence floor, ``spot_fallback_after``).
        Composes with :meth:`revocations` chaos on the simulator — the
        autopilot *reacts* to the same Poisson process the fault
        injection drives."""
        from .autopilot import AutopilotSpec

        spec = AutopilotSpec(
            budget_usd=None if budget is None else float(budget),
            price_feed=price_feed,
            adaptive_deadline=bool(adaptive_deadline),
            risk_checkpointing=bool(risk_checkpointing),
            **knobs,
        )
        return self._clone(_autopilot=spec)

    def hierarchy(
        self,
        regions: Union[int, Mapping[str, Sequence[str]]] = 4,
        *,
        cohort: Any = None,
        sharded: bool = False,
        seed: int = 0,
    ) -> "Experiment":
        """Two-level aggregation on the in-process *serve* target.

        ``regions`` partitions the clients across regional aggregators —
        an int (round-robin into that many regions) or an explicit
        ``{region_id: [client_ids]}`` mapping.  Each region runs its own
        async round engine (deadline, carry-over, and §4.3 re-request
        state are region-private) and exports a weighted
        :class:`~repro_torch.federated.agg_engine.PartialSum`; the parent
        folds the partials, which is numerically identical to the flat
        fold over the same clients.

        ``cohort`` turns on per-round client sampling: a float fraction
        in ``(0, 1]``, an int fixed size, or a
        :class:`~repro_torch.federated.hierarchy.CohortSampler` (``seed``
        feeds the sampler when built here).  ``sharded=True`` reduces
        the parent's stacked regional accumulators across devices with a
        pod-axis ``psum``.

        Validated at chain time; like :meth:`chaos`, the virtual-clock
        simulator target rejects it (it models one flat aggregation
        server), and the socket transport drives flat rounds — the
        hierarchy is an in-process :meth:`serve` concept."""
        from ..federated.hierarchy import as_cohort_sampler

        if isinstance(regions, bool):
            raise TypeError(
                "regions must be an int or a {region_id: [client_ids]} "
                "mapping"
            )
        if isinstance(regions, int):
            if regions < 1:
                raise ValueError(f"need at least one region, got {regions}")
            region_spec: Union[int, Dict[str, List[str]]] = regions
        elif isinstance(regions, Mapping):
            region_spec = {
                str(rid): [str(c) for c in cids]
                for rid, cids in regions.items()
            }
            if not region_spec:
                raise ValueError("region mapping is empty")
        else:
            raise TypeError(
                f"regions must be an int or a {{region_id: [client_ids]}} "
                f"mapping, got {type(regions).__name__}"
            )
        sampler = as_cohort_sampler(cohort, seed=int(seed))
        return self._clone(_hierarchy={
            "regions": region_spec,
            "cohort": sampler,
            "sharded": bool(sharded),
        })

    def chaos(self, plan: Any) -> "Experiment":
        """Attach a :class:`~repro_torch.federated.chaos.FaultPlan` to the
        chain's *serve* targets.

        One seeded plan, both drivers: on the in-process engine the plan
        decorates the arrival schedule (``ChaosSchedule``); on the
        socket transport the driver executes its driver-level kinds and
        the silos' ``ChaosClient`` wrappers execute the client-level
        kinds physically.  Every injected fault appears as a
        ``FaultInjected`` event on the run's bus.  The virtual-clock
        *simulator* target models revocations with its own Poisson
        process (:meth:`revocations`) — chaos plans are a serve-target
        concept, so :meth:`build`/:meth:`simulate` reject them."""
        from ..federated.chaos import FaultPlan

        if not isinstance(plan, FaultPlan):
            raise TypeError(
                f"chaos() takes a repro_torch.federated.chaos.FaultPlan, "
                f"got {type(plan).__name__}"
            )
        return self._clone(_chaos=plan)

    def transport(
        self,
        kind: str = "thread",
        *,
        reply_timeout_s: Optional[float] = None,
        on_revocation: str = "rerequest",
        max_rerequests: int = 1,
        host: str = "127.0.0.1",
        port: int = 0,
        startup_timeout_s: float = 30.0,
        heartbeat_interval_s: Optional[float] = None,
        heartbeat_timeout_s: Optional[float] = None,
        reconnect: Optional[Any] = None,
    ) -> "Experiment":
        """Run :meth:`serve` over the wall-clock socket transport.

        With a transport configured, :meth:`serve` returns a
        ``repro_torch.federated.transport.LiveRoundDriver`` whose silos are
        real ``FLClient`` workers behind length-prefixed TCP sockets —
        ``kind="thread"`` (CI-friendly loopback threads; ``serve`` takes
        the client objects) or ``kind="process"`` (``multiprocessing``
        spawn; ``serve`` takes a ``{client_id: factory}`` mapping of
        picklable constructors).  The chain's deadline / carry /
        escalation settings apply unchanged: the driver replays measured
        arrivals through the same fold engine, so simulated, in-process,
        and socket-backed runs share one configuration surface and one
        trace vocabulary.

        ``reply_timeout_s`` bounds each phase's physical wait before a
        silent silo becomes a §4.3 suspected fault (None waits
        indefinitely); ``on_revocation`` / ``max_rerequests`` pick the
        §4.3 recovery rule for crashed workers.

        Hardening knobs (see ``LiveRoundDriver``):
        ``heartbeat_interval_s`` enables liveness probing at that
        cadence, with ``heartbeat_timeout_s`` (default 3x the interval)
        the no-PONG bound past which a silo is declared hung — not
        merely slow — and crashed; ``reconnect`` is a
        ``repro_torch.federated.transport.ReconnectPolicy`` giving workers
        bounded exponential-backoff connect retries.
        """
        if kind not in ("thread", "process"):
            raise ValueError("transport kind must be 'thread' or 'process'")
        if on_revocation not in ("rerequest", "exclude"):
            raise ValueError("on_revocation must be 'rerequest' or 'exclude'")
        if reply_timeout_s is not None and reply_timeout_s <= 0.0:
            raise ValueError("reply_timeout_s must be positive (or None)")
        if max_rerequests < 0:
            raise ValueError("max_rerequests must be >= 0")
        if heartbeat_interval_s is not None and heartbeat_interval_s <= 0.0:
            raise ValueError("heartbeat_interval_s must be positive (or None)")
        if heartbeat_timeout_s is not None:
            if heartbeat_timeout_s <= 0.0:
                raise ValueError(
                    "heartbeat_timeout_s must be positive (or None)"
                )
            if heartbeat_interval_s is None:
                raise ValueError(
                    "heartbeat_timeout_s requires heartbeat_interval_s "
                    "(a timeout without probes can never be hit)"
                )
        if reconnect is not None:
            from ..federated.transport import ReconnectPolicy

            if not isinstance(reconnect, ReconnectPolicy):
                raise TypeError(
                    f"reconnect= takes a repro_torch.federated.transport."
                    f"ReconnectPolicy, got {type(reconnect).__name__}"
                )
        exp = self._clone()
        exp._transport = {
            "kind": kind,
            "reply_timeout_s": reply_timeout_s,
            "on_revocation": on_revocation,
            "max_rerequests": max_rerequests,
            "host": host,
            "port": port,
            "startup_timeout_s": startup_timeout_s,
            "heartbeat_interval_s": heartbeat_interval_s,
            "heartbeat_timeout_s": heartbeat_timeout_s,
            "reconnect": reconnect,
        }
        return exp

    # -- deadline adaptation ----------------------------------------------
    def _resolved_min_clients(self) -> int:
        if self._min_clients is not None:
            return self._min_clients
        policy_min = getattr(self._deadline, "min_clients", None)
        return int(policy_min) if policy_min is not None else 1

    def _sim_deadline(
        self,
    ) -> Optional[Union[float, Callable[[int, Dict[str, float]], float]]]:
        """Adapt the deadline spec to the simulator's float-or-callable."""
        spec = self._deadline
        if spec is None:
            return None
        if isinstance(spec, (int, float)):
            return float(spec)
        from ..federated.async_server import ClientArrival, RoundDeadline

        if isinstance(spec, RoundDeadline):
            if spec.min_weight_frac > 0.0:
                # The virtual-clock simulator does not model per-silo
                # example weights, so a weight quorum cannot be honored
                # there — refusing beats silently diverging from serve().
                raise ValueError(
                    "the simulator target cannot honor a RoundDeadline "
                    "min_weight_frac quorum (it has no per-silo example "
                    "weights); use min_clients, or run this policy on the "
                    "live target via .serve()"
                )
            policy = spec

            def from_policy(round_idx: int, offsets: Dict[str, float]) -> float:
                arrivals = {
                    cid: ClientArrival(cid, t) for cid, t in offsets.items()
                }
                return float(policy.deadline_s(round_idx, arrivals))

            return from_policy
        if callable(spec):
            return cast(Callable[[int, Dict[str, float]], float], spec)
        raise TypeError(f"unsupported deadline spec: {spec!r}")

    def _live_deadline(self) -> Any:
        """Adapt the deadline spec to a live-engine RoundDeadline policy."""
        spec = self._deadline
        if spec is None:
            return None
        from ..federated.async_server import (
            CallableDeadline,
            FixedDeadline,
            RoundDeadline,
        )

        if isinstance(spec, RoundDeadline):
            # An explicit .async_rounds(min_clients=...) override wins over
            # the policy's own quorum, matching _resolved_min_clients() on
            # the simulator target — one chain, one quorum, both targets.
            if (
                self._min_clients is not None
                and spec.min_clients != self._min_clients
            ):
                spec = dataclasses.replace(spec, min_clients=self._min_clients)
            return spec
        min_clients = self._resolved_min_clients()
        if isinstance(spec, (int, float)):
            return FixedDeadline(t_round_s=float(spec), min_clients=min_clients)
        if callable(spec):
            return CallableDeadline(fn=spec, min_clients=min_clients)
        raise TypeError(f"unsupported deadline spec: {spec!r}")

    # -- terminal operations -----------------------------------------------
    def build(self) -> "SimulationConfig":
        """Validate the chain and produce the (shim) ``SimulationConfig``."""
        from .simulator import SimulationConfig

        if self._env is None:
            raise ValueError("Experiment needs an environment: Experiment.on(env)")
        if self._app is None:
            raise ValueError("Experiment needs an application: .app(app)")
        if self._chaos is not None:
            raise ValueError(
                "a chaos FaultPlan applies to the serve() targets (the "
                "in-process engine and the socket transport); the "
                "simulator target models faults with .revocations(k_r=...)"
            )
        if self._compression is not None:
            raise ValueError(
                "wire compression applies to the serve() targets (real "
                "payloads cross a real or virtual wire there); the "
                "simulator target models message sizes analytically — "
                "feed it measured compressed sizes via the cost model"
            )
        if self._schema is not None:
            raise ValueError(
                "an update schema applies to the serve() targets (real "
                "structured payloads cross a real or virtual wire "
                "there); the simulator target models message sizes "
                "analytically — feed it measured per-group sizes via "
                "the cost model"
            )
        if self._hierarchy is not None:
            raise ValueError(
                "a hierarchy applies to the in-process serve() target "
                "(regional engines fold real partial sums there); the "
                "simulator target models a single flat aggregation server"
            )
        fields = dict(self._overrides)
        if self._deadline is not None:
            fields["round_deadline"] = self._sim_deadline()
            fields["deadline_min_clients"] = self._resolved_min_clients()
        if self._autopilot is not None:
            fields["autopilot"] = self._autopilot
        config = SimulationConfig(**fields)
        config.validate(self._app)
        return config

    def simulate(self) -> "SimulationResult":
        """Build and run the virtual-clock simulator (§5 engine)."""
        from .simulator import MultiCloudSimulator

        config = self.build()
        assert self._env is not None and self._app is not None
        return MultiCloudSimulator(self._env, self._app, config).run()

    # Chain settings that only the simulator target can honor: the live
    # engine gets its revocations from the ArrivalSchedule, checkpoints
    # from manager objects, and its round count from run(n).
    _SIM_ONLY_FIELDS = frozenset({
        "alpha", "server_market", "client_market", "k_r", "seed",
        "vm_startup_s", "checkpoint", "remove_revoked", "n_rounds",
        "use_greedy_mapping", "mapping_prices", "aggreg_time_fn",
    })

    def serve(
        self,
        clients: Union[Sequence[Any], Mapping[str, Any]],
        initial_params: Any,
        *,
        schedule: Optional[Any] = None,
        **server_kwargs: Any,
    ) -> Any:
        """Build the matching live target from the same chain.

        Without a :meth:`transport` in the chain this is the in-process
        ``AsyncFLServer`` (real ``FLClient`` objects, arrivals modeled by
        an ``ArrivalSchedule``); with one it is the wall-clock
        ``LiveRoundDriver`` (real workers behind sockets, arrivals
        measured).  Unlike :meth:`build`, no environment/application is
        required.  The sync barrier protocol is the degenerate
        (InstantSchedule) case of the same server.  Chain settings that
        only the simulator can honor (markets, revocations, checkpoint
        policies, ...) are rejected here rather than silently dropped —
        configure the live target via ``serve(...)`` kwargs (checkpoint
        managers, fault hooks, schedules, cost models) instead.

        ``device=`` (a ``serve`` keyword) is where the server and, over
        the socket transport, the workers hold their weights; left out,
        each takes its own default, the card."""
        stray = sorted(self._SIM_ONLY_FIELDS & set(self._overrides))
        if stray:
            raise ValueError(
                f"builder settings {stray} apply only to the simulator "
                "target (.build()/.simulate()); the live engine takes the "
                "equivalent configuration as serve(...) keyword arguments"
            )
        if self._autopilot is not None:
            ap = self._autopilot
            if ap.price_feed is not None or ap.risk_checkpointing:
                raise ValueError(
                    "autopilot price feeds and risk-aware checkpoint "
                    "cadence are simulator-target concepts (VM billing and "
                    "CheckpointPolicy live there); the serve() targets "
                    "honor budget= and adaptive_deadline=True"
                )
            ap_bus = server_kwargs.setdefault("bus", EventBus())
            if ap.budget_usd is not None:
                from .autopilot import BudgetTracker

                # The bus keeps the tracker alive via its subscription;
                # it turns any CostAccrued the run publishes into
                # BudgetExceeded when the ledger crosses.
                BudgetTracker(ap.budget_usd).attach(ap_bus)
            if ap.adaptive_deadline:
                if "round_deadline" in server_kwargs:
                    raise ValueError(
                        "adaptive_deadline and an explicit round_deadline= "
                        "kwarg both claim T_round — drop one"
                    )
                if self._deadline is not None and not isinstance(
                    self._deadline, (int, float)
                ):
                    raise ValueError(
                        "adaptive_deadline replaces the chain's deadline "
                        "policy/callable: seed it with a float "
                        "async_rounds(deadline=<seconds>), or pass none to "
                        "bootstrap from the first round's arrivals"
                    )
                from ..federated.async_server import CallableDeadline

                controller = ap.build_controller(
                    initial_t_round_s=(
                        float(self._deadline)
                        if isinstance(self._deadline, (int, float))
                        else None
                    ),
                    round_cost_allowance_usd=None,
                )
                controller.attach(ap_bus)
                server_kwargs["round_deadline"] = CallableDeadline(
                    fn=controller.propose,
                    min_clients=self._resolved_min_clients(),
                )
        # Chain-derived engine settings; an explicit serve(...) kwarg wins.
        server_kwargs.setdefault("round_deadline", self._live_deadline())
        server_kwargs.setdefault("carry_discount", self._carry_discount)
        server_kwargs.setdefault(
            "escalate_after",
            int(self._overrides.get("deadline_escalate_after", 2)),
        )
        spec = self._transport
        if spec is not None:
            if self._hierarchy is not None:
                raise ValueError(
                    "the hierarchy runs in-process: regional engines fold "
                    "partial sums in the server's process, while the socket "
                    "transport drives a flat round loop — drop .transport() "
                    "or .hierarchy()"
                )
            if schedule is not None:
                raise ValueError(
                    "an ArrivalSchedule is a virtual-clock concept; the "
                    "socket transport measures real arrivals — drop "
                    "schedule= or drop .transport()"
                )
            from ..federated.transport import (
                LiveRoundDriver,
                ProcessWorkerPool,
                SocketTransport,
                ThreadWorkerPool,
            )

            # The workers' weights land where the driver's do.
            pool_kw: Dict[str, Any] = {}
            if "device" in server_kwargs:
                pool_kw["device"] = server_kwargs["device"]

            if spec["kind"] == "process":
                if not isinstance(clients, Mapping):
                    raise TypeError(
                        "transport kind='process' takes a {client_id: "
                        "picklable factory} mapping, not client objects "
                        "(they must be constructible in the child process)"
                    )
                if self._chaos is not None:
                    raise ValueError(
                        "chaos plans need ChaosClient wrappers around "
                        "live client objects; process-mode factories "
                        "build clients in the child — use "
                        "transport(kind='thread') for chaos runs"
                    )
                workers: Any = ProcessWorkerPool(
                    clients, initial_params, reconnect=spec["reconnect"],
                    compression=self._compression,
                    schema=self._schema,
                    **pool_kw,
                )
            else:
                if isinstance(clients, Mapping):
                    raise TypeError(
                        "transport kind='thread' takes a sequence of "
                        "FLClient objects (factories are for process mode)"
                    )
                live_clients: Sequence[Any] = clients
                if self._chaos is not None:
                    # Client-level fault kinds execute physically inside
                    # the workers; driver-level kinds are the driver's
                    # (chaos= below).
                    live_clients = self._chaos.wrap_clients(clients)
                workers = ThreadWorkerPool(
                    live_clients, initial_params, reconnect=spec["reconnect"],
                    compression=self._compression,
                    schema=self._schema,
                    **pool_kw,
                )
            if self._chaos is not None:
                server_kwargs.setdefault("chaos", self._chaos)
            # Spec-derived driver knobs follow the same kwargs-win rule
            # as the simulator fields: an explicit serve() kwarg beats
            # the builder chain.
            server_kwargs.setdefault(
                "on_revocation", str(spec["on_revocation"])
            )
            server_kwargs.setdefault(
                "max_rerequests", int(spec["max_rerequests"])
            )
            server_kwargs.setdefault("reply_timeout_s", spec["reply_timeout_s"])
            server_kwargs.setdefault(
                "startup_timeout_s", float(spec["startup_timeout_s"])
            )
            server_kwargs.setdefault(
                "heartbeat_interval_s", spec["heartbeat_interval_s"]
            )
            server_kwargs.setdefault(
                "heartbeat_timeout_s", spec["heartbeat_timeout_s"]
            )
            server_kwargs.setdefault("compression", self._compression)
            server_kwargs.setdefault("schema", self._schema)
            return LiveRoundDriver(
                workers,
                initial_params,
                transport=SocketTransport(
                    host=str(spec["host"]), port=int(spec["port"])
                ),
                **server_kwargs,
            )
        if isinstance(clients, Mapping):
            raise TypeError(
                "client factories require the socket transport: add "
                ".transport(kind='process') to the chain, or pass "
                "FLClient objects"
            )
        from ..federated.async_server import AsyncFLServer

        if self._chaos is not None:
            # One plan, the virtual-clock driver: decorate the arrival
            # schedule so the plan rewrites this engine's arrivals, and
            # share the server's bus so FaultInjected markers land in
            # the same trace the engine writes.
            from ..federated.async_server import InstantSchedule
            from ..federated.chaos import ChaosSchedule

            bus = server_kwargs.setdefault("bus", EventBus())
            schedule = ChaosSchedule(
                schedule if schedule is not None else InstantSchedule(),
                self._chaos,
                bus=bus,
            )
        server_kwargs.setdefault("compression", self._compression)
        server_kwargs.setdefault("schema", self._schema)
        if self._hierarchy is not None:
            from ..federated.hierarchy import HierarchicalFLServer

            server_kwargs.setdefault("regions", self._hierarchy["regions"])
            server_kwargs.setdefault("cohort", self._hierarchy["cohort"])
            server_kwargs.setdefault("sharded", self._hierarchy["sharded"])
            return HierarchicalFLServer(
                clients,
                initial_params,
                schedule=schedule,
                **server_kwargs,
            )
        return AsyncFLServer(
            clients,
            initial_params,
            schedule=schedule,
            **server_kwargs,
        )
