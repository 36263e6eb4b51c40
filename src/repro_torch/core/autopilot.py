"""Cost autopilot: the online control loop over the static cost heuristic.

This is the port's own copy of ``repro/core/autopilot.py``, which uses no JAX:
the same classes, fields and arithmetic, so both packages' schedulers
make the same decisions.  The port imports nothing of the JAX package;
the text below is the reference's, and its module names point into
that package.

The paper fixes every cost knob up front: cost_{jkl} constants, one
T_round, a fixed checkpoint interval.  This module (ROADMAP direction 3,
FedCostAware-shaped) closes the loop on the existing
:class:`~repro.core.events.EventBus` with four coordinated parts:

1. **Prices** — a :class:`~repro.core.cloud_model.PriceFeed` makes spot
   markets move; the drivers publish typed
   :class:`~repro.core.events.PriceUpdated` ticks for allocated VMs
   (:class:`PriceTicker`), and billing integrates the walk instead of
   multiplying a constant.
2. **Budget** — :class:`BudgetTracker` folds the `CostAccrued` stream
   into $ spent against a budget, publishing `BudgetExceeded` once when
   it crosses; :class:`BudgetedMapper` picks initial markets by
   revocation-adjusted expected cost under that budget, and
   :class:`CostAwareScheduler` ranks §4.4 replacement (vm, market)
   pairs with the accrued-budget pressure tilting Eq. 3 toward cost.
3. **Checkpoint cadence** — see
   :class:`~repro.core.fault_tolerance.RiskAwareCheckpointPolicy`,
   which subscribes to `RevocationOccurred`/`PriceUpdated`.
4. **Deadline** — :class:`DeadlineController` retunes T_round online
   from observed arrival quantiles, carry-over pressure, and $/round,
   publishing `DeadlineAdjusted`; its :meth:`DeadlineController.propose`
   is *both* the simulator's deadline callable and the live engine's
   ``CallableDeadline.fn``, so one controller drives both drivers.

Configure it through ``Experiment.autopilot(budget=..., price_feed=...,
adaptive_deadline=True, risk_checkpointing=True)``; see
``docs/control_plane.md`` ("Cost autopilot").
"""
from __future__ import annotations

import dataclasses
import math
from typing import (
    Callable,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Protocol,
    Tuple,
)

from .cloud_model import PriceFeed, VMType
from .cost_model import SERVER, Assignment, CostModel
from .dynamic_scheduler import BudgetSignal, DynamicScheduler
from .events import (
    BudgetExceeded,
    CostAccrued,
    DeadlineAdjusted,
    DeadlineExpired,
    Event,
    EventBus,
    PriceUpdated,
    RoundDispatched,
    UpdateArrived,
)
from .initial_mapping import MappingSolution

__all__ = [
    "AutopilotSpec",
    "BudgetTracker",
    "BudgetedMapper",
    "CostAwareScheduler",
    "DeadlineController",
    "PriceTicker",
]


def _quantile(values: List[float], q: float) -> float:
    """Linear-interpolation quantile (numpy semantics, no numpy)."""
    if not values:
        raise ValueError("quantile of empty sequence")
    vs = sorted(values)
    pos = q * (len(vs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AutopilotSpec:
    """Validated autopilot configuration (built by ``Experiment.autopilot``).

    At least one feature must be on: a $ budget, a moving price feed, the
    adaptive deadline controller, or risk-aware checkpoint cadence.  The
    remaining fields are controller/cadence knobs with conservative
    defaults; they are validated here so a bad chain fails at build time,
    not rounds into a run."""

    budget_usd: Optional[float] = None
    price_feed: Optional[PriceFeed] = None
    adaptive_deadline: bool = False
    risk_checkpointing: bool = False
    # Deadline-controller knobs (part 4).
    target_quantile: float = 0.9
    deadline_slack: float = 1.2
    min_t_round_s: Optional[float] = None
    max_t_round_s: Optional[float] = None
    max_step_frac: float = 0.25
    adjust_threshold_frac: float = 0.02
    carry_gain: float = 0.5
    cost_gain: float = 0.5
    # Risk-aware checkpoint knobs (part 3).
    min_checkpoint_interval_rounds: int = 1
    checkpoint_price_sensitivity: float = 1.0
    # Cost-aware scheduler knob (part 2): spot revocations inside the
    # cooldown window before a task falls back to on-demand replacements.
    spot_fallback_after: int = 2

    def __post_init__(self) -> None:
        if (
            self.budget_usd is None
            and self.price_feed is None
            and not self.adaptive_deadline
            and not self.risk_checkpointing
        ):
            raise ValueError(
                "autopilot with every feature off: pass a budget=, a "
                "price_feed=, adaptive_deadline=True, or "
                "risk_checkpointing=True"
            )
        if self.budget_usd is not None and self.budget_usd <= 0.0:
            raise ValueError("budget_usd must be positive")
        if not 0.0 < self.target_quantile <= 1.0:
            raise ValueError("target_quantile must be in (0, 1]")
        if self.deadline_slack < 1.0:
            raise ValueError("deadline_slack must be >= 1 (closing before "
                             "the target quantile starves the quorum)")
        for name in ("min_t_round_s", "max_t_round_s"):
            value: Optional[float] = getattr(self, name)
            if value is not None and value <= 0.0:
                raise ValueError(f"{name} must be positive (or None)")
        if (
            self.min_t_round_s is not None
            and self.max_t_round_s is not None
            and self.min_t_round_s > self.max_t_round_s
        ):
            raise ValueError("min_t_round_s exceeds max_t_round_s")
        if not 0.0 < self.max_step_frac <= 1.0:
            raise ValueError("max_step_frac must be in (0, 1]")
        if self.adjust_threshold_frac < 0.0:
            raise ValueError("adjust_threshold_frac must be >= 0")
        if self.carry_gain < 0.0 or self.cost_gain < 0.0:
            raise ValueError("carry_gain/cost_gain must be >= 0")
        if self.min_checkpoint_interval_rounds < 1:
            raise ValueError("min_checkpoint_interval_rounds must be >= 1")
        if self.checkpoint_price_sensitivity < 0.0:
            raise ValueError("checkpoint_price_sensitivity must be >= 0")
        if self.spot_fallback_after < 1:
            raise ValueError("spot_fallback_after must be >= 1")

    def build_controller(
        self,
        initial_t_round_s: Optional[float] = None,
        round_cost_allowance_usd: Optional[float] = None,
    ) -> "DeadlineController":
        """A :class:`DeadlineController` wired with this spec's knobs
        (one construction path for the simulator and live targets)."""
        return DeadlineController(
            initial_t_round_s=initial_t_round_s,
            target_quantile=self.target_quantile,
            slack=self.deadline_slack,
            min_t_round_s=self.min_t_round_s,
            max_t_round_s=self.max_t_round_s,
            max_step_frac=self.max_step_frac,
            adjust_threshold_frac=self.adjust_threshold_frac,
            carry_gain=self.carry_gain,
            cost_gain=self.cost_gain,
            round_cost_allowance_usd=round_cost_allowance_usd,
        )

    def features(self) -> Tuple[str, ...]:
        """The enabled feature names (for docs/telemetry)."""
        out: List[str] = []
        if self.budget_usd is not None:
            out.append("budget")
        if self.price_feed is not None:
            out.append("price_feed")
        if self.adaptive_deadline:
            out.append("adaptive_deadline")
        if self.risk_checkpointing:
            out.append("risk_checkpointing")
        return tuple(out)


# ---------------------------------------------------------------------------
# Part 1: price ticks
# ---------------------------------------------------------------------------

class PriceTicker:
    """Publishes `PriceUpdated` for VMs whose spot quote moved.

    The drivers call :meth:`publish_updates` at round boundaries with
    the VMs the run currently occupies on the spot market — the bus
    carries market moves the run can *act* on, not the whole exchange.
    The first tick for a VM is measured against its listed price, so a
    feed that opens away from the listing is visible in the trace."""

    def __init__(self, feed: PriceFeed) -> None:
        self.feed = feed
        self._last: Dict[str, float] = {}

    def publish_updates(
        self,
        bus: EventBus,
        vms: Iterable[VMType],
        now_s: float,
        round_idx: int = 0,
    ) -> List[PriceUpdated]:
        events: List[PriceUpdated] = []
        seen: Dict[str, VMType] = {}
        for vm in vms:
            seen.setdefault(vm.vm_id, vm)
        for vm_id in sorted(seen):
            vm = seen[vm_id]
            price = self.feed.spot_price_per_hour(vm, now_s)
            prev = self._last.get(vm_id, vm.cost_spot_hour)
            if price != prev:
                events.append(bus.publish(PriceUpdated(
                    now_s, vm_id, price, prev, vm.cost_spot_hour, round_idx
                )))
            self._last[vm_id] = price
        return events


# ---------------------------------------------------------------------------
# Part 2a: budget tracking
# ---------------------------------------------------------------------------

class BudgetTracker:
    """Folds the `CostAccrued` stream into $ spent against a budget.

    Implements the scheduler's `BudgetSignal` Protocol: ``pressure()``
    is the drained fraction in [0, 1].  Crossing the budget publishes
    `BudgetExceeded` exactly once (the run continues — abandoning a
    cross-silo round mid-flight wastes the money already spent)."""

    def __init__(self, budget_usd: float) -> None:
        if budget_usd <= 0.0:
            raise ValueError("budget_usd must be positive")
        self.budget_usd = float(budget_usd)
        self.spent_usd = 0.0
        self.exceeded = False
        self._bus: Optional[EventBus] = None

    def attach(self, bus: EventBus) -> Callable[[], None]:
        """Subscribe to ``bus``'s `CostAccrued` stream (and publish
        `BudgetExceeded` there); returns an unsubscribe callable."""
        self._bus = bus
        return bus.subscribe(CostAccrued, self._on_cost)

    def _on_cost(self, event: Event) -> None:
        assert isinstance(event, CostAccrued)
        self.add(event.amount, now_s=event.time_s, round_idx=event.round_idx)

    def add(self, amount: float, now_s: float = 0.0, round_idx: int = 0) -> None:
        self.spent_usd += amount
        if self.spent_usd > self.budget_usd and not self.exceeded:
            self.exceeded = True
            if self._bus is not None:
                self._bus.publish(BudgetExceeded(
                    now_s, self.spent_usd, self.budget_usd, "tracker", round_idx
                ))

    def pressure(self) -> float:
        return min(1.0, self.spent_usd / self.budget_usd)

    def remaining_usd(self) -> float:
        return max(0.0, self.budget_usd - self.spent_usd)


_BUDGET_SIGNAL_WITNESS: Callable[[BudgetTracker], BudgetSignal] = lambda t: t
"""mypy witness: BudgetTracker satisfies the scheduler's BudgetSignal."""


# ---------------------------------------------------------------------------
# Part 2b: budget-constrained policies (MapperAPI / SchedulerAPI)
# ---------------------------------------------------------------------------

class MapperLike(Protocol):
    """Structural stand-in for `control_plane.MapperAPI` (a local Protocol
    so this module's import graph keeps pointing strictly downward)."""

    def solve(self) -> MappingSolution:
        ...

    def solve_greedy(self) -> MappingSolution:
        ...


class BudgetedMapper:
    """`MapperAPI` wrapper choosing per-task *markets* under a $ budget.

    VM choice stays with the wrapped §4.2 solver; this layer decides,
    per task, whether the chosen VM runs spot or on-demand by comparing
    the *revocation-adjusted* expected per-round cost: a spot instance
    pays its (feed-quoted) rate plus, with the Poisson revocation
    probability over a round, the replacement spin-up and an expected
    half-round of redone work.  Spot wins only when it still wins after
    that adjustment — at high revocation rates the mapper gracefully
    falls back to on-demand by arithmetic, not by special case.

    If even the chosen markets project past the budget over the full
    run, a `BudgetExceeded` (source="mapper") is published at solve
    time and the cheapest placement is returned anyway."""

    def __init__(
        self,
        inner: MapperLike,
        cost_model: CostModel,
        budget_usd: Optional[float] = None,
        n_rounds: int = 1,
        k_r: Optional[float] = None,
        vm_startup_s: float = 154.0,
        server_spot_ok: bool = False,
        bus: Optional[EventBus] = None,
    ) -> None:
        if n_rounds < 1:
            raise ValueError("n_rounds must be >= 1")
        if budget_usd is not None and budget_usd <= 0.0:
            raise ValueError("budget_usd must be positive (or None)")
        if k_r is not None and k_r <= 0.0:
            raise ValueError("k_r must be positive (or None)")
        self.inner = inner
        self.cost_model = cost_model
        self.budget_usd = budget_usd
        self.n_rounds = n_rounds
        self.k_r = k_r
        self.vm_startup_s = vm_startup_s
        self.server_spot_ok = server_spot_ok
        self.bus = bus
        self.projected_run_cost_usd: Optional[float] = None

    # -- MapperAPI ---------------------------------------------------------
    def solve(self) -> MappingSolution:
        return self._with_markets(self.inner.solve())

    def solve_greedy(self) -> MappingSolution:
        return self._with_markets(self.inner.solve_greedy())

    # -- market selection --------------------------------------------------
    def expected_round_cost(
        self, vm_id: str, market: str, makespan_s: float
    ) -> float:
        """Revocation-adjusted expected $ for one task-round on ``vm_id``."""
        rate = self.cost_model.price_per_second(vm_id, market, 0.0)
        cost = rate * makespan_s
        if market == "spot" and self.k_r is not None:
            p_rev = 1.0 - math.exp(-makespan_s / self.k_r)
            # A revoked task pays the replacement spin-up and, in
            # expectation, redoes half the round it was interrupted in.
            cost += rate * p_rev * (self.vm_startup_s + 0.5 * makespan_s)
        return cost

    def _with_markets(self, base: MappingSolution) -> MappingSolution:
        makespan_s = base.evaluation.makespan_s
        placement: Dict[str, Assignment] = {}
        for task, a in base.placement.items():
            if task == SERVER and not self.server_spot_ok:
                # The paper's rule: the aggregation server is the single
                # point of failure, so it stays on-demand.
                placement[task] = Assignment(a.vm_id, "on_demand")
                continue
            od = self.expected_round_cost(a.vm_id, "on_demand", makespan_s)
            spot = self.expected_round_cost(a.vm_id, "spot", makespan_s)
            placement[task] = Assignment(
                a.vm_id, "spot" if spot < od else "on_demand"
            )
        base.placement = placement
        projected = self.n_rounds * (
            sum(
                self.expected_round_cost(a.vm_id, a.market, makespan_s)
                for a in placement.values()
            )
            + self.cost_model.comm_costs(placement)
        )
        self.projected_run_cost_usd = projected
        if (
            self.budget_usd is not None
            and projected > self.budget_usd
            and self.bus is not None
        ):
            self.bus.publish(BudgetExceeded(
                0.0, projected, self.budget_usd, "mapper", 0
            ))
        return base


class CostAwareScheduler(DynamicScheduler):
    """`SchedulerAPI` policy with the autopilot hooks always on.

    A :class:`~repro.core.dynamic_scheduler.DynamicScheduler` that ranks
    §4.4 replacement candidates as (vm, market) pairs even before a
    budget or feed is bound — bind a :class:`BudgetTracker` via
    ``scheduler.budget = tracker`` to add accrued-budget pressure."""

    def __init__(
        self,
        cost_model: CostModel,
        revoked_cooldown_s: float = 3600.0,
        price_feed: Optional[PriceFeed] = None,
        spot_fallback_after: int = 2,
        budget: Optional[BudgetSignal] = None,
    ) -> None:
        super().__init__(
            cost_model,
            revoked_cooldown_s=revoked_cooldown_s,
            price_feed=price_feed,
            spot_fallback_after=spot_fallback_after,
        )
        self.budget = budget

    @property
    def market_aware(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# Part 4: adaptive deadline controller
# ---------------------------------------------------------------------------

class DeadlineController:
    """Retunes T_round online from the event stream (autopilot part 4).

    An `EventBus` subscriber on `UpdateArrived` / `DeadlineExpired` /
    `CostAccrued` / `PriceUpdated` (plus `RoundDispatched` to rebase
    absolute-clock arrivals onto round offsets).  After each round's
    `DeadlineExpired` it recomputes the target::

        target = EMA(q-quantile of arrival offsets) * slack
                 * (1 + carry_gain * EMA(late fraction))     # extend
                 / (1 + cost_gain  * cost_signal)            # tighten

    where ``cost_signal`` is the larger of the spot-price heat
    (EMA quote/listed - 1) and the $/round overrun against
    ``round_cost_allowance_usd`` (budget / n_rounds, when known).  The
    move is clamped to ``max_step_frac`` per round and to
    [min_t_round_s, max_t_round_s]; moves above
    ``adjust_threshold_frac`` publish a typed `DeadlineAdjusted`.

    :meth:`propose` is the deadline function for *both* drivers — the
    simulator's ``round_deadline`` callable and the live engine's
    ``CallableDeadline.fn`` — so one controller instance closes the
    loop wherever the rounds actually run."""

    def __init__(
        self,
        initial_t_round_s: Optional[float] = None,
        target_quantile: float = 0.9,
        slack: float = 1.2,
        min_t_round_s: Optional[float] = None,
        max_t_round_s: Optional[float] = None,
        max_step_frac: float = 0.25,
        adjust_threshold_frac: float = 0.02,
        carry_gain: float = 0.5,
        cost_gain: float = 0.5,
        ema: float = 0.5,
        round_cost_allowance_usd: Optional[float] = None,
    ) -> None:
        if initial_t_round_s is not None and initial_t_round_s <= 0.0:
            raise ValueError("initial_t_round_s must be positive (or None)")
        if not 0.0 < target_quantile <= 1.0:
            raise ValueError("target_quantile must be in (0, 1]")
        if slack < 1.0:
            raise ValueError("slack must be >= 1")
        if not 0.0 < max_step_frac <= 1.0:
            raise ValueError("max_step_frac must be in (0, 1]")
        if not 0.0 < ema <= 1.0:
            raise ValueError("ema must be in (0, 1]")
        self.target_quantile = target_quantile
        self.slack = slack
        self.min_t_round_s = min_t_round_s
        self.max_t_round_s = max_t_round_s
        self.max_step_frac = max_step_frac
        self.adjust_threshold_frac = adjust_threshold_frac
        self.carry_gain = carry_gain
        self.cost_gain = cost_gain
        self.ema = ema
        self.round_cost_allowance_usd = round_cost_allowance_usd
        # Observed state.
        self._t_current: Optional[float] = (
            None if initial_t_round_s is None else self._clamp(initial_t_round_s)
        )
        self._dispatch: Dict[int, float] = {}
        self._arrivals: Dict[int, List[float]] = {}
        self._ema_quantile: Optional[float] = None
        self._carry_pressure = 0.0
        self._price_heat = 0.0
        self._round_cost: Dict[int, float] = {}
        self._ema_round_cost: Optional[float] = None
        self._bus: Optional[EventBus] = None
        self.adjustments: List[DeadlineAdjusted] = []

    # -- wiring ------------------------------------------------------------
    def attach(self, bus: EventBus) -> Callable[[], None]:
        """Subscribe the observers to ``bus``; returns an unsubscribe."""
        self._bus = bus
        unsubs = [
            bus.subscribe(RoundDispatched, self._on_dispatch),
            bus.subscribe(UpdateArrived, self._on_arrival),
            bus.subscribe(DeadlineExpired, self._on_deadline_expired),
            bus.subscribe(CostAccrued, self._on_cost),
            bus.subscribe(PriceUpdated, self._on_price),
        ]

        def unsubscribe() -> None:
            for u in unsubs:
                u()

        return unsubscribe

    @property
    def t_round_s(self) -> Optional[float]:
        """The controller's current T_round (None until bootstrapped)."""
        return self._t_current

    # -- the deadline function (both drivers) ------------------------------
    def propose(self, round_idx: int, offsets: Mapping[str, float]) -> float:
        """T_round for ``round_idx``; bootstraps from the first round's
        offsets (quantile * slack) when no initial value was given."""
        if self._t_current is None:
            if offsets:
                base = _quantile(list(offsets.values()), self.target_quantile)
                self._t_current = self._clamp(base * self.slack)
            else:
                self._t_current = self._clamp(
                    self.min_t_round_s if self.min_t_round_s is not None else 1.0
                )
        return self._t_current

    # -- observers ---------------------------------------------------------
    def _on_dispatch(self, event: Event) -> None:
        assert isinstance(event, RoundDispatched)
        self._dispatch[event.round_idx] = event.time_s

    def _on_arrival(self, event: Event) -> None:
        assert isinstance(event, UpdateArrived)
        dispatch = self._dispatch.get(event.round_idx)
        # Simulator arrivals are absolute-clock (>= the round's dispatch);
        # live fold arrivals are already round-relative (and can sit below
        # the server's wall-clock dispatch stamp) — rebase only when the
        # subtraction is meaningful.
        if dispatch is not None and event.time_s >= dispatch:
            offset = event.time_s - dispatch
        else:
            offset = event.time_s
        self._arrivals.setdefault(event.round_idx, []).append(offset)

    def _on_cost(self, event: Event) -> None:
        assert isinstance(event, CostAccrued)
        self._round_cost[event.round_idx] = (
            self._round_cost.get(event.round_idx, 0.0) + event.amount
        )

    def _on_price(self, event: Event) -> None:
        assert isinstance(event, PriceUpdated)
        ratio = event.price_per_hour / event.listed_per_hour
        self._price_heat += self.ema * (max(0.0, ratio - 1.0) - self._price_heat)

    def _on_deadline_expired(self, event: Event) -> None:
        assert isinstance(event, DeadlineExpired)
        round_idx = event.round_idx
        arrivals = self._arrivals.pop(round_idx, [])
        self._dispatch.pop(round_idx, None)
        if arrivals:
            q = _quantile(arrivals, self.target_quantile)
            if self._ema_quantile is None:
                self._ema_quantile = q
            else:
                self._ema_quantile += self.ema * (q - self._ema_quantile)
        total = len(event.on_time) + len(event.late)
        if total > 0:
            late_frac = len(event.late) / total
            self._carry_pressure += self.ema * (late_frac - self._carry_pressure)
        # Fold completed rounds' $ into the per-round EMA (a round's comm
        # and VM costs land after its DeadlineExpired, so earlier rounds
        # are complete by now).
        for k in sorted(r for r in self._round_cost if r < round_idx):
            cost = self._round_cost.pop(k)
            if self._ema_round_cost is None:
                self._ema_round_cost = cost
            else:
                self._ema_round_cost += self.ema * (cost - self._ema_round_cost)
        self._retune(round_idx, event.time_s)

    # -- the control law ---------------------------------------------------
    def _cost_signal(self) -> float:
        signal = self._price_heat
        if (
            self.round_cost_allowance_usd is not None
            and self._ema_round_cost is not None
            and self.round_cost_allowance_usd > 0.0
        ):
            overrun = self._ema_round_cost / self.round_cost_allowance_usd - 1.0
            signal = max(signal, overrun)
        return max(0.0, signal)

    def _clamp(self, t: float) -> float:
        if self.min_t_round_s is not None:
            t = max(t, self.min_t_round_s)
        if self.max_t_round_s is not None:
            t = min(t, self.max_t_round_s)
        return t

    def _retune(self, round_idx: int, now_s: float) -> None:
        if self._ema_quantile is None:
            return  # no arrival evidence yet
        carry = self.carry_gain * self._carry_pressure
        cost = self.cost_gain * self._cost_signal()
        target = self._clamp(
            self._ema_quantile * self.slack * (1.0 + carry) / (1.0 + cost)
        )
        current = self._t_current
        if current is None:
            self._t_current = target
            return
        step = self.max_step_frac * current
        new = self._clamp(min(max(target, current - step), current + step))
        if abs(new - current) > self.adjust_threshold_frac * current:
            if new > current:
                reason = "carry" if carry > 0.02 else "arrivals"
            else:
                reason = "cost" if cost > 0.02 else "arrivals"
            adjusted = DeadlineAdjusted(now_s, round_idx, current, new, reason)
            if self._bus is not None:
                self._bus.publish(adjusted)
            self.adjustments.append(adjusted)
            self._t_current = new
