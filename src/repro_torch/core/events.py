"""Typed event vocabulary + in-process bus for the Multi-FedLS control plane.

This is the port's own copy of ``repro/core/events.py``: the same event
classes with the same fields and the same bus, so a round driven by
``repro_torch`` publishes the trace a round driven by ``repro`` does.
The port imports nothing of the JAX package; the text below is the
reference's, and its module names point into that package.

The paper's four modules (Pre-Scheduling, Initial Mapping, Fault
Tolerance, Dynamic Scheduler — Fig. 1/§4) cooperate through *events*:
a round is dispatched, updates arrive and are folded, VMs are revoked
and replaced, deadlines expire, checkpoints become durable.  This module
gives those interactions a typed, frozen vocabulary and a tiny
synchronous :class:`EventBus` so that the virtual-clock simulator
(`repro.core.simulator`) and the live round engine
(`repro.federated.async_server`) emit **the same trace language** — the
control plane (`repro.core.control_plane`) orchestrates both through it.

Every event is a frozen dataclass carrying ``time_s``: seconds on the
publisher's clock.  The simulator publishes on its global virtual clock;
the live engine publishes fold-level events on the round's virtual
clock and server-level events on the wall clock since run start (see
``docs/control_plane.md``).  Frozen events compare by value, which is
what makes trace-determinism assertions (`tests/test_control_plane.py`)
and the shim-equivalence pin possible.

Publication is synchronous and in-process: ``publish`` appends to the
trace (when recording) and invokes subscribers immediately, so the bus
adds only a dict lookup and a list append per event — the
`benchmarks/control_plane_bench.py` harness pins this overhead at <5%
of a deadline-bench round.  :data:`NULL_BUS` is the zero-cost sink for
callers that want no tracing at all.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Type, TypeVar

__all__ = [
    "BudgetExceeded",
    "CheckpointSaved",
    "CostAccrued",
    "DeadlineAdjusted",
    "DeadlineExpired",
    "Event",
    "EventBus",
    "FaultInjected",
    "NULL_BUS",
    "NullBus",
    "PartialFolded",
    "PriceUpdated",
    "RecoveryCompleted",
    "RegionClosed",
    "RevocationOccurred",
    "RoundClosed",
    "RoundDispatched",
    "StragglerEscalated",
    "UpdateArrived",
    "UpdateFolded",
    "VMReplaced",
]


# ---------------------------------------------------------------------------
# Event catalog
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Event:
    """Base class: every control-plane event is timestamped."""

    time_s: float


@dataclasses.dataclass(frozen=True)
class RoundDispatched(Event):
    """The server sent ``s_msg_train`` to the round's cohort.

    ``deadline_s`` is the planned T_round close time on the publisher's
    clock (like every ``*_s`` field); None means no deadline."""

    round_idx: int
    n_clients: int
    deadline_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class UpdateArrived(Event):
    """One silo's ``c_msg_train`` landed on the server."""

    round_idx: int
    task: str
    attempt: int = 1  # >1 after a §4.3 re-request


@dataclasses.dataclass(frozen=True)
class UpdateFolded(Event):
    """An update entered the round's weighted average.

    ``origin_round`` is set on carried-in (stale) folds only;
    ``folded_weight`` is the example weight after the staleness discount
    (== ``weight`` for a fresh fold)."""

    round_idx: int
    task: str
    weight: float
    folded_weight: float
    origin_round: Optional[int] = None

    @property
    def stale(self) -> bool:
        return self.origin_round is not None


@dataclasses.dataclass(frozen=True)
class RevocationOccurred(Event):
    """A spot VM was revoked (§4.3 hard fault).

    In the simulator ``old_vm``/``new_vm`` name the replaced allocation;
    the live engine publishes empty strings (its transport does not
    manage VMs — the §4.3 re-request/exclude recovery is recorded via
    the follow-up :class:`UpdateArrived` attempt, or its absence)."""

    task: str
    old_vm: str = ""
    new_vm: str = ""
    round_idx: int = 0
    interrupted_round: bool = False


@dataclasses.dataclass(frozen=True)
class DeadlineExpired(Event):
    """A partial round closed at its effective (quorum-extended) T_round.

    Both deadline fields are on the publisher's clock — the simulator's
    absolute virtual clock, or the live engine's round-relative clock —
    so they compare directly against that trace's ``UpdateArrived``
    times."""

    round_idx: int
    deadline_s: float                       # effective close time
    policy_deadline_s: float                # raw T_round from the policy
    on_time: Tuple[str, ...] = ()
    late: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class StragglerEscalated(Event):
    """A silo hit ``escalate_after`` consecutive deadline misses (§4.4
    soft fault) and was routed to the Dynamic Scheduler.  The live
    engine publishes empty VM ids (the ``on_straggler`` subscriber owns
    the placement)."""

    task: str
    old_vm: str = ""
    new_vm: str = ""
    round_idx: int = 0
    consecutive_misses: int = 0


@dataclasses.dataclass(frozen=True)
class CheckpointSaved(Event):
    """A checkpoint became durable (server off-VM copy or client local)."""

    round_idx: int
    location: str       # "server_remote" | "client_local" | "policy"
    overhead_s: float   # synchronous time the round paid for it


@dataclasses.dataclass(frozen=True)
class RecoveryCompleted(Event):
    """A faulted task is runnable again on its replacement VM."""

    task: str
    resume_round: int
    delay_s: float
    restored_from: str  # "server_remote" | "client_local:<cid>" | "none"


@dataclasses.dataclass(frozen=True)
class VMReplaced(Event):
    """The Dynamic Scheduler moved a task to a new instance."""

    task: str
    old_vm: str
    new_vm: str
    market: str
    reason: str  # "revocation" | "straggler"


@dataclasses.dataclass(frozen=True)
class FaultInjected(Event):
    """A chaos-engineering fault was deliberately injected (not observed).

    Published by the :mod:`repro.federated.chaos` harness on whichever
    driver executes the :class:`~repro.federated.chaos.FaultPlan`, right
    where the fault enters the system — so a trace always shows the
    *cause* next to the §4.3/§4.4 recovery events it provokes, and the
    soak invariant "every injected fault is paired with a recovery or
    exclusion" is checkable from the trace alone.  ``kind`` is one of
    ``repro.federated.chaos.FAULT_KINDS``; ``phase`` is ``"train"`` or
    ``"eval"``."""

    kind: str
    task: str
    round_idx: int = 0
    phase: str = "train"


@dataclasses.dataclass(frozen=True)
class RoundClosed(Event):
    """One FL round's aggregate is ready."""

    round_idx: int
    span_s: float
    carried_over: Tuple[str, ...] = ()  # late silos parked for the next round
    carried_in: Tuple[str, ...] = ()    # stale silos folded into this round


@dataclasses.dataclass(frozen=True)
class RegionClosed(Event):
    """One region's cohort fold is complete; its partial sum is exported.

    The regional analogue of :class:`RoundClosed`: published by the
    hierarchy coordinator on the *parent* bus when a
    :class:`~repro.federated.hierarchy.RegionalAggregator` finishes its
    cohort round (the region's own engine publishes the usual per-fold
    vocabulary on its private bus).  ``span_s`` is the region's round
    span on its virtual clock; ``carried_over`` names the region's late
    silos parked for its next round."""

    round_idx: int
    region: str
    span_s: float
    n_folded: int = 0
    carried_over: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class PartialFolded(Event):
    """A regional :class:`~repro.federated.agg_engine.PartialSum` entered
    the parent round's accumulator.

    ``weight`` is the region's raw (undiscounted) weight total and
    ``n_clients`` its cohort contribution — summing them across a
    round's ``PartialFolded`` events reproduces the flat engine's
    normalizer, which is what the weight-conservation audits check.
    ``base_round`` tags the global weights the partial was accumulated
    against (must equal the parent's base round)."""

    round_idx: int
    region: str
    n_clients: int
    weight: float
    base_round: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class CostAccrued(Event):
    """Financial cost charged to the run (message egress, VM-seconds)."""

    kind: str  # "comm" | "vm" | "resend"
    amount: float
    round_idx: int = 0


@dataclasses.dataclass(frozen=True)
class PriceUpdated(Event):
    """A spot market moved: one VM type's $/hour changed.

    Published by the cost autopilot (`repro.core.autopilot`) at round
    boundaries for VMs the run has allocated on the spot market —
    ``price_per_hour`` is the feed's current quote, ``prev_per_hour``
    the last published one, and ``listed_per_hour`` the static
    `VMType.cost_spot_hour` the walk is anchored to.  The risk-aware
    checkpoint policy and the deadline controller subscribe to this."""

    vm_id: str
    price_per_hour: float
    prev_per_hour: float
    listed_per_hour: float
    round_idx: int = 0


@dataclasses.dataclass(frozen=True)
class BudgetExceeded(Event):
    """The run's accrued cost crossed its $ budget.

    Published once per run by the autopilot's `BudgetTracker` (on the
    `CostAccrued` stream) or by the `BudgetedMapper` when even the
    cheapest feasible placement projects past the budget — the run
    continues (cross-silo training is not abandoned mid-flight), but
    every cost-aware policy sees full budget pressure from then on."""

    spent: float
    budget: float
    source: str  # "tracker" | "mapper"
    round_idx: int = 0


@dataclasses.dataclass(frozen=True)
class DeadlineAdjusted(Event):
    """The adaptive deadline controller retuned T_round.

    ``old_t_round_s``/``new_t_round_s`` are round-relative seconds (the
    value handed to the deadline policy, not an absolute clock time);
    ``reason`` names the dominant pressure behind the move:
    ``"arrivals"`` (tracking the observed arrival quantile),
    ``"carry"`` (late silos piling up — extend), or ``"cost"``
    ($/round or spot prices running hot — tighten)."""

    round_idx: int
    old_t_round_s: float
    new_t_round_s: float
    reason: str


# ---------------------------------------------------------------------------
# Bus
# ---------------------------------------------------------------------------

E = TypeVar("E", bound=Event)
Handler = Callable[[Event], None]


class EventBus:
    """Synchronous, in-process, typed pub/sub with an optional trace.

    Subscriptions dispatch on the event's exact type (``type(event)``);
    pass ``event_type=None`` to observe every event.  ``publish``
    returns the event so call sites can publish-and-use in one
    expression.  With ``record=True`` (the default) every published
    event is appended to :attr:`trace` in publication order — the
    replayable timeline that :mod:`scripts.trace_dump` pretty-prints.

    The trace grows with the run: a long-lived server folding thousands
    of rounds should pass ``max_events`` (keeps at least the most recent
    ``max_events``, trimmed in batches so appends stay amortized O(1)),
    call :meth:`clear` between rounds, or use :data:`NULL_BUS` to
    disable tracing entirely.
    """

    def __init__(
        self, record: bool = True, max_events: Optional[int] = None
    ) -> None:
        if max_events is not None and max_events < 1:
            raise ValueError("max_events must be >= 1 (or None for unbounded)")
        self.record = record
        self.max_events = max_events
        self.trace: List[Event] = []
        self._handlers: Dict[Type[Event], List[Handler]] = {}
        self._any: List[Handler] = []

    # -- subscription -----------------------------------------------------
    def subscribe(
        self, event_type: Optional[Type[Event]], handler: Handler
    ) -> Callable[[], None]:
        """Register ``handler`` for ``event_type`` (None = all events);
        returns an idempotent unsubscribe callable."""
        handlers = (
            self._any
            if event_type is None
            else self._handlers.setdefault(event_type, [])
        )
        handlers.append(handler)

        def unsubscribe() -> None:
            if handler in handlers:
                handlers.remove(handler)

        return unsubscribe

    # -- publication ------------------------------------------------------
    def publish(self, event: E) -> E:
        if self.record:
            self.trace.append(event)
            if (
                self.max_events is not None
                and len(self.trace) >= 2 * self.max_events
            ):
                # Batched trim: let the list grow to 2x the cap, then cut
                # back to exactly max_events — the newest events always
                # survive and appends stay amortized O(1).
                del self.trace[: len(self.trace) - self.max_events]
        handlers = self._handlers.get(type(event))
        if handlers:
            # Snapshot: a handler may unsubscribe (itself or a peer)
            # mid-dispatch without skipping anyone for THIS event.
            for handler in tuple(handlers):
                handler(event)
        if self._any:
            for handler in tuple(self._any):
                handler(event)
        return event

    # -- trace access -----------------------------------------------------
    def events_of(self, *types: Type[Event]) -> List[Event]:
        """Trace filtered to the given event types, publication order."""
        return [e for e in self.trace if isinstance(e, types)]

    def clear(self) -> None:
        self.trace.clear()


class NullBus(EventBus):
    """A bus that drops everything: the zero-overhead baseline used by
    `benchmarks/control_plane_bench.py` to pin the event-bus cost."""

    def __init__(self) -> None:
        super().__init__(record=False)

    def publish(self, event: E) -> E:
        return event


NULL_BUS = NullBus()
