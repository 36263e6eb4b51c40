"""Async round engine: straggler-folding FL rounds on the StreamingAggregator.

The port of ``repro/federated/async_server.py`` but for structured
updates and partial sums.  The paper's §3 protocol barriers every round
on the slowest silo: the server collects all N ``c_msg_train`` messages,
then aggregates.  In multi-cloud runs (§4.3/§5) stragglers and spot-VM
revocations dominate round time, so this engine folds each
``c_msg_train`` into a
:class:`~repro_torch.federated.agg_engine.StreamingAggregator` the moment
it arrives (O(L) accumulator memory, never an (N, L) gather), and the
round barriers only on the *round count*.

Arrival schedules map ``(round_idx, client_ids)`` to per-client
:class:`ClientArrival` events on a virtual clock that starts at the
round's ``s_msg_train`` dispatch: :class:`InstantSchedule` (every message
present at dispatch — the degenerate case that is the barrier
``FLServer``: one ``fedavg_reduce`` launch), :class:`DeterministicSchedule`,
:class:`HeavyTailSchedule` (lognormal delays with stragglers) and
:class:`RevocationInjector` (Poisson spot revocations from
:mod:`repro_torch.core.revocation`).  A revocation before delivery is
recovered per §4.3: re-requested (the replacement VM retrains) or, with
``on_revocation="exclude"``, dropped from this round only.

The fold loop advances a virtual clock but charges each fold with the
*measured* cost of the real ``StreamingAggregator.add``, which ends in
a device synchronize (``fold_cost_s`` fixes it for deterministic runs).

A :class:`RoundDeadline` policy (:class:`FixedDeadline`,
:class:`QuantileDeadline`, :class:`CallableDeadline`,
:class:`CostModelDeadline`) closes a round at its quorum-extended
``T_round``; a silo that misses it is parked in the engine's
:class:`~repro_torch.federated.agg_engine.CarryOverBuffer` and folded into
the next round's average with a staleness discount, and repeated misses
are §4.4 escalations (``StragglerEscalated`` on the bus).

:class:`AsyncFLServer` with ``compression=`` is the compressed wire path:
each client's delta against the round's global weights is encoded
(int8 / fp16 / top-k, with error feedback) and folded straight into the
fp32 accumulator — int8 and fp16 through the ``dequant_fold`` kernel.
A compressed update that misses the deadline is materialized against its
own round's base before it is parked.

With ``schema=`` updates are structured: each client's update is encoded
as a :class:`~repro_torch.federated.compression.StructuredUpdate` of the
schema's named groups (per-group error feedback when compression is on)
and folded by the per-group aggregator; federated LoRA ships and folds
only its adapters.  Partial sums (``emit_partial=True``, ``ROADMAP.md``
queue 1, item 13) raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..core.control_plane import StragglerTracker
from ..core.events import (
    DeadlineExpired,
    EventBus,
    RevocationOccurred,
    RoundClosed,
    StragglerEscalated,
    UpdateArrived,
    UpdateFolded,
)
from ..core.revocation import RevocationModel, RevocationSampler
from .agg_engine import (
    AgeDiscount,
    AggregationEngine,
    CarryEntry,
    CarryOverBuffer,
    ResolvedSchema,
    StalenessPolicy,
    UpdateSchema,
    as_update_schema,
    plan_for,
)
from .client import ClientResult, synchronize, tree_device
from .compression import (
    ClientCompressor,
    CompressedUpdate,
    StructuredCompressor,
    StructuredUpdate,
    materialize_structured,
    materialize_update,
    parse_compression,
)

__all__ = [
    "ArrivalSchedule",
    "AsyncFLServer",
    "AsyncRoundEngine",
    "CallableDeadline",
    "ClientArrival",
    "CostModelDeadline",
    "DeterministicSchedule",
    "FixedDeadline",
    "FoldEvent",
    "FoldReport",
    "HeavyTailSchedule",
    "InstantSchedule",
    "QuantileDeadline",
    "RevocationInjector",
    "RoundDeadline",
]


# ---------------------------------------------------------------------------
# Arrival model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClientArrival:
    """One client's ``c_msg_train`` arrival event on the round's virtual clock.

    ``re_arrival_s`` is the *recorded* §4.3 re-request arrival: the live
    socket transport physically restarts a crashed worker and measures
    when its retrained update lands, so the engine replays that measured
    time instead of computing ``revoke_at + recovery_delay + delay``.
    ``math.inf`` means the re-request never landed inside the round's
    horizon — the silo is excluded; None keeps the virtual-clock model.
    """

    client_id: str
    delay_s: float                      # dispatch -> message-on-server
    revoke_at_s: Optional[float] = None  # spot VM revoked at this time (None = survives)
    re_arrival_s: Optional[float] = None  # measured re-request arrival (live transport)

    def delivered_before_revocation(self) -> bool:
        return self.revoke_at_s is None or self.revoke_at_s > self.delay_s

    def rerequest_arrival(self, recovery_delay_s: float) -> float:
        """When the re-requested update lands: the recorded time if the
        transport measured one, else the virtual-clock model."""
        if self.re_arrival_s is not None:
            return self.re_arrival_s
        assert self.revoke_at_s is not None
        return self.revoke_at_s + recovery_delay_s + self.delay_s


class ArrivalSchedule:
    """Maps a round to per-client arrival events (virtual seconds)."""

    def round_arrivals(
        self, round_idx: int, client_ids: Sequence[str]
    ) -> Dict[str, ClientArrival]:
        raise NotImplementedError


class InstantSchedule(ArrivalSchedule):
    """Every message is present at dispatch: the barrier server's timeline.

    With this schedule the async engine degenerates to one fused batch
    reduce (all inputs available at t=0), which is exactly the sync
    ``FLServer`` hot path."""

    def round_arrivals(
        self, round_idx: int, client_ids: Sequence[str]
    ) -> Dict[str, ClientArrival]:
        return {cid: ClientArrival(cid, 0.0) for cid in client_ids}


class DeterministicSchedule(ArrivalSchedule):
    """Fixed delays (scalar or per-client) and optional revocation times."""

    def __init__(
        self,
        delays: Union[float, Mapping[str, float]],
        revoke_at: Optional[Mapping[str, float]] = None,
    ) -> None:
        self.delays = delays
        self.revoke_at = dict(revoke_at or {})

    def round_arrivals(
        self, round_idx: int, client_ids: Sequence[str]
    ) -> Dict[str, ClientArrival]:
        out: Dict[str, ClientArrival] = {}
        for cid in client_ids:
            d = self.delays if isinstance(self.delays, (int, float)) else self.delays[cid]
            out[cid] = ClientArrival(cid, float(d), self.revoke_at.get(cid))
        return out


class HeavyTailSchedule(ArrivalSchedule):
    """Lognormal arrival delays with heavy-tail stragglers.

    Each client's delay is ``base_s * lognormal(0, sigma)``; clients in
    ``straggler_ids`` (or hit by ``straggler_prob`` each round) are
    multiplied by ``straggler_factor`` — the 1-slow-silo-in-8 shape the
    paper's multi-cloud traces show."""

    def __init__(
        self,
        base_s: float = 1.0,
        sigma: float = 0.25,
        straggler_ids: Sequence[str] = (),
        straggler_factor: float = 5.0,
        straggler_prob: float = 0.0,
        seed: int = 0,
    ) -> None:
        self.base_s = base_s
        self.sigma = sigma
        self.straggler_ids = frozenset(straggler_ids)
        self.straggler_factor = straggler_factor
        self.straggler_prob = straggler_prob
        self._rng = np.random.default_rng(seed)

    def round_arrivals(
        self, round_idx: int, client_ids: Sequence[str]
    ) -> Dict[str, ClientArrival]:
        out: Dict[str, ClientArrival] = {}
        for cid in client_ids:
            d = self.base_s * float(self._rng.lognormal(0.0, self.sigma))
            if cid in self.straggler_ids or (
                self.straggler_prob > 0.0
                and self._rng.uniform() < self.straggler_prob
            ):
                d *= self.straggler_factor
            out[cid] = ClientArrival(cid, d)
        return out


class RevocationInjector(ArrivalSchedule):
    """Decorate any schedule with Poisson spot revocations (§5.6 model).

    Events are drawn from the *global* Poisson process of
    :class:`~repro_torch.core.revocation.RevocationModel` against a running
    cross-round clock; each event landing inside a round's horizon
    revokes one uniformly-chosen still-running spot client (a client
    whose message has not yet arrived).  Events with no live spot
    victim are absorbed, matching the revocation module's semantics."""

    def __init__(
        self,
        inner: ArrivalSchedule,
        model: RevocationModel,
        spot_clients: Optional[Sequence[str]] = None,
        horizon_s: Optional[float] = None,
    ) -> None:
        self.inner = inner
        self.spot_clients = None if spot_clients is None else frozenset(spot_clients)
        self.horizon_s = horizon_s
        self._sampler: RevocationSampler = model.sampler()
        self._clock = 0.0
        self._next_event = self._sampler.next_event_after(0.0)

    def round_arrivals(
        self, round_idx: int, client_ids: Sequence[str]
    ) -> Dict[str, ClientArrival]:
        arrivals = dict(self.inner.round_arrivals(round_idx, client_ids))
        horizon = self.horizon_s
        if horizon is None:
            horizon = max((a.delay_s for a in arrivals.values()), default=0.0)
        round_end = self._clock + horizon

        while self._next_event <= round_end:
            t = self._next_event - self._clock  # round-local virtual time
            self._next_event = self._sampler.next_event_after(self._next_event)
            live_spot = sorted(
                cid
                for cid, a in arrivals.items()
                if a.delay_s > t
                and a.revoke_at_s is None
                and (self.spot_clients is None or cid in self.spot_clients)
            )
            victim = self._sampler.pick_victim(live_spot)
            if victim is None:
                continue
            a = arrivals[victim]
            arrivals[victim] = dataclasses.replace(a, revoke_at_s=t)
        self._clock = round_end
        return arrivals


# ---------------------------------------------------------------------------
# Deadline policies (T_round folding)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RoundDeadline:
    """Partial-round closure policy: when does the round stop waiting?

    ``deadline_s`` maps a round to its T_round on the round's virtual
    clock (seconds from ``s_msg_train`` dispatch).  The quorum fields
    guard against closing a round on too little evidence: the effective
    deadline extends to the earliest time at which at least
    ``min_clients`` fresh silos *and* ``min_weight_frac`` of the round's
    deliverable example weight have arrived.
    """

    min_clients: int = 1
    min_weight_frac: float = 0.0

    def __post_init__(self) -> None:
        # min_clients >= 1 guarantees every round has at least one fresh
        # fold (a zero-quorum deadline could park the whole cohort and
        # leave nothing to aggregate).
        if self.min_clients < 1:
            raise ValueError("min_clients must be >= 1")
        if not 0.0 <= self.min_weight_frac <= 1.0:
            raise ValueError("min_weight_frac must be in [0, 1]")

    def deadline_s(
        self, round_idx: int, arrivals: Mapping[str, ClientArrival]
    ) -> float:
        raise NotImplementedError

    def effective_deadline(
        self,
        round_idx: int,
        arrivals: Mapping[str, ClientArrival],
        deliveries: Mapping[str, float],
        weights: Mapping[str, float],
    ) -> float:
        """T_round extended (never shrunk) until the quorum is met.

        ``deliveries`` are final per-client delivery times *after* §4.3
        re-request resolution — a re-requested silo can still be the one
        that satisfies the quorum."""
        t = float(self.deadline_s(round_idx, arrivals))
        if not deliveries:
            return t
        order = sorted(deliveries.items(), key=lambda kv: (kv[1], kv[0]))
        need_n = min(int(self.min_clients), len(order))
        need_w = float(self.min_weight_frac) * sum(
            weights[cid] for cid, _ in order
        )
        got_n, got_w, t_quorum = 0, 0.0, -math.inf
        for cid, delivery in order:
            if got_n >= need_n and got_w + 1e-12 >= need_w:
                break
            got_n += 1
            got_w += weights[cid]
            t_quorum = delivery
        return max(t, t_quorum)


@dataclasses.dataclass(frozen=True)
class FixedDeadline(RoundDeadline):
    """Constant T_round: the per-round share of the application deadline T."""

    t_round_s: float = math.inf

    def deadline_s(
        self, round_idx: int, arrivals: Mapping[str, ClientArrival]
    ) -> float:
        return self.t_round_s


@dataclasses.dataclass(frozen=True)
class QuantileDeadline(RoundDeadline):
    """T_round = ``slack`` x the q-quantile of this round's arrival delays.

    Adapts to each round's arrival distribution (q=0.75, slack=1.0 closes
    on the fastest three quarters), which is the FedCostAware-style lever
    for cost control on spot capacity: the deadline tracks the cohort, not
    a wall-clock constant."""

    q: float = 0.75
    slack: float = 1.0

    def deadline_s(
        self, round_idx: int, arrivals: Mapping[str, ClientArrival]
    ) -> float:
        delays = [a.delay_s for a in arrivals.values()]
        if not delays:
            return 0.0
        return float(self.slack) * float(np.quantile(delays, self.q))


@dataclasses.dataclass(frozen=True)
class CallableDeadline(RoundDeadline):
    """Adapts a simulator-style ``(round_idx, {client: delay_s}) ->
    seconds`` callable to the live engine's :class:`RoundDeadline`
    surface — the ``Experiment`` builder uses this so one deadline spec
    drives both the virtual-clock and the live target."""

    fn: Any = None

    def deadline_s(
        self, round_idx: int, arrivals: Mapping[str, ClientArrival]
    ) -> float:
        if self.fn is None:
            raise ValueError("CallableDeadline needs a callable fn")
        offsets = {cid: a.delay_s for cid, a in arrivals.items()}
        return float(self.fn(round_idx, offsets))


@dataclasses.dataclass(frozen=True)
class CostModelDeadline(RoundDeadline):
    """T_round derived from the cost model's worst-case round bound.

    ``frac * CostModel.t_max()`` — t_max (Eq. 7's normalizer) is the
    worst round time over every client/VM/server-VM choice, so any silo
    slower than a ``frac`` share of it is pathological by the model's own
    accounting and belongs in the carry-over path."""

    cost_model: Any = None
    frac: float = 1.0

    def deadline_s(
        self, round_idx: int, arrivals: Mapping[str, ClientArrival]
    ) -> float:
        if self.cost_model is None:
            raise ValueError("CostModelDeadline needs a CostModel instance")
        return float(self.cost_model.deadline_from_t_max(self.frac))


# ---------------------------------------------------------------------------
# Fold engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FoldEvent:
    """One client fold on the round's virtual clock."""

    client_id: str
    arrival_s: float       # when its c_msg_train became foldable
    fold_start_s: float    # server picked it up (>= arrival; folds serialize)
    fold_end_s: float
    attempt: int = 1       # >1 after a revocation re-request
    revoked_at_s: Optional[float] = None
    weight: float = 0.0         # raw example weight folded (n_samples)
    folded_weight: float = 0.0  # after staleness discount (== weight when fresh)
    origin_round: Optional[int] = None  # set on carried-in (stale) folds only

    @property
    def is_stale(self) -> bool:
        return self.origin_round is not None


@dataclasses.dataclass
class FoldReport:
    """Result of one async round fold."""

    params: Any
    events: List[FoldEvent]
    excluded: List[str]           # silos dropped this round (exclude policy)
    rerequested: List[str]        # silos whose update was re-requested
    fold_times: Dict[str, float]  # client_id -> virtual fold-completion time
    round_span_s: float           # dispatch -> aggregated params ready
    busy_s: float                 # server time spent folding
    idle_s: float                 # round_span_s - busy_s (waiting on arrivals)
    # Counterfactual: wait for the last arrival, then do the SAME fold
    # work (last_arrival + busy_s).  With measured fold costs this is an
    # upper bound on the real sync FLServer's span — the barrier path
    # runs the fused batch reduce, which beats N incremental folds; see
    # benchmarks/async_round_bench.py for the measured-batch comparison.
    # Under a deadline the counterfactual is the barrier-on-count
    # timeline: wait for every deliverable message (including the ones the
    # deadline deferred), then fold them all.
    barrier_span_s: float
    # Deadline accounting (None / empty when the round ran without one):
    deadline_s: Optional[float] = None        # effective close (quorum-extended)
    policy_deadline_s: Optional[float] = None  # raw T_round from the policy
    carried_over: List[str] = dataclasses.field(default_factory=list)
    carried_in: List[str] = dataclasses.field(default_factory=list)
    escalations: List[str] = dataclasses.field(default_factory=list)

    @property
    def span_saved_s(self) -> float:
        """Round time the streaming fold hides vs. barriering on the last
        arrival and then doing the same fold work (see barrier_span_s for
        why this bounds, rather than equals, the sync-server saving)."""
        return self.barrier_span_s - self.round_span_s


class AsyncRoundEngine:
    """Folds one round's client results in arrival order.

    Parameters
    ----------
    agg_engine : the fused :class:`AggregationEngine` (stats and the
        degenerate batch path route through it).
    on_revocation : §4.3 recovery rule for an update lost to revocation:
        ``"rerequest"`` (default — the replacement VM retrains, arriving
        ``recovery_delay_s + delay`` after the revocation, so the silo is
        still in the round's average) or ``"exclude"`` (drop the silo
        from this round only).
    recovery_delay_s : virtual VM replacement + restore time charged
        before a re-requested client restarts training.
    max_rerequests : re-request budget per client per round; a client
        revoked more than this many times is excluded.
    fold_cost_s : override the virtual cost of each fold (deterministic
        tests / simulators); None charges the measured wall-clock cost
        of the real ``StreamingAggregator.add``.
    deadline : default :class:`RoundDeadline` policy for every round
        (``fold_round`` can override per call).  None keeps the
        barrier-on-count behaviour: the round waits for every silo.
    carry_discount : staleness discount applied to a carried-over update's
        example weight per round of lateness (``weight * discount**age``).
    escalate_after : consecutive deadline misses by the same silo before
        it is reported in ``FoldReport.escalations`` and published as a
        :class:`~repro_torch.core.events.StragglerEscalated` bus event (§4.4
        soft-fault escalation to the Dynamic Scheduler); the streak is
        tracked by the control plane's shared
        :class:`~repro_torch.core.control_plane.StragglerTracker` and resets
        on an on-time delivery or an escalation.
    bus : control-plane :class:`~repro_torch.core.events.EventBus` the engine
        publishes its typed fold trace on (UpdateArrived, UpdateFolded,
        RevocationOccurred, DeadlineExpired, StragglerEscalated,
        RoundClosed — all on the round's virtual clock).  None creates a
        private recording bus; pass ``repro_torch.core.events.NULL_BUS`` to
        disable tracing entirely.
    schema : an :class:`~repro_torch.federated.agg_engine.UpdateSchema` (or a
        group mapping): rounds with a base fold through the per-group
        :class:`~repro_torch.federated.agg_engine.StructuredStreamingAggregator`.
    staleness_policy : the carried-over weight rule; None keeps
        ``AgeDiscount(carry_discount)``.
    """

    def __init__(
        self,
        agg_engine: Optional[AggregationEngine] = None,
        on_revocation: str = "rerequest",
        recovery_delay_s: float = 0.0,
        max_rerequests: int = 1,
        fold_cost_s: Optional[float] = None,
        deadline: Optional[RoundDeadline] = None,
        carry_discount: float = 0.5,
        escalate_after: int = 2,
        bus: Optional[EventBus] = None,
        schema: Union[None, UpdateSchema, Mapping[str, Any]] = None,
        staleness_policy: Optional[StalenessPolicy] = None,
    ) -> None:
        if on_revocation not in ("rerequest", "exclude"):
            raise ValueError("on_revocation must be 'rerequest' or 'exclude'")
        if not 0.0 <= carry_discount <= 1.0:
            raise ValueError("carry_discount must be in [0, 1]")
        self.agg_engine = agg_engine if agg_engine is not None else AggregationEngine()
        self.on_revocation = on_revocation
        self.recovery_delay_s = recovery_delay_s
        self.max_rerequests = max_rerequests
        self.fold_cost_s = fold_cost_s
        self.deadline = deadline
        self.carry_discount = carry_discount
        self.escalate_after = escalate_after
        self.bus = bus if bus is not None else EventBus()
        # Structured updates: rounds with a base fold through the
        # per-group StructuredStreamingAggregator under this schema.
        self.schema = as_update_schema(schema)
        self._resolved_schema: Optional[ResolvedSchema] = None
        # Carried-over weight rule; None keeps the age discount
        # (AgeDiscount(carry_discount) — bit-identical arithmetic).
        self.staleness_policy = staleness_policy
        # Cross-round state: late updates awaiting their discounted fold,
        # and per-silo consecutive deadline-miss streaks (the same §4.4
        # policy object the simulator's control plane uses — validates
        # escalate_after >= 1).
        self.carry = CarryOverBuffer()
        self.stragglers = StragglerTracker(escalate_after)

    # ------------------------------------------------------------------
    def _resolve_schema(self, base_params: Any) -> Optional[ResolvedSchema]:
        if self.schema is None or base_params is None:
            return None
        plan = plan_for(base_params)
        if (self._resolved_schema is None
                or self._resolved_schema.plan.signature != plan.signature):
            self._resolved_schema = self.schema.resolve(base_params)
        return self._resolved_schema

    def _park_delta_norm(
        self, park_params: Any, base_params: Any
    ) -> Optional[float]:
        """||update - base||_2 at park time (drift-aware staleness input).

        Measured against whatever base the fold ran with; None when the
        round had no base (nothing to measure against) or the policy in
        use never reads drift."""
        policy = self.staleness_policy
        if base_params is None or policy is None or not policy.uses_drift:
            return None
        return float(self._distance_to_base(park_params, base_params))

    def _distance_to_base(self, params: Any, base_params: Any) -> float:
        """L2 distance between an update (a tree, or per-group raw vectors)
        and the given global weights (in fp32, as the reference's
        ``np.linalg.norm`` of fp32 vectors; the two sum in other orders, so
        they agree to rounding)."""
        if isinstance(params, Mapping) and self.schema is not None:
            resolved = self._resolve_schema(base_params)
            if resolved is not None and all(k in dict(resolved.groups) for k in params):
                total = 0.0
                for name, vec in params.items():
                    g = resolved.group(name).flatten(base_params)
                    d = torch.as_tensor(vec).to(g.device, torch.float32) - g
                    total += float(torch.dot(d, d))
                return math.sqrt(total)
        plan = plan_for(base_params)
        g = plan.flatten(base_params)
        d_full = plan.flatten(params).to(g.device) - g
        return float(torch.linalg.vector_norm(d_full))

    def _carry_multiplier(
        self, entry: CarryEntry, round_idx: int, base_params: Any
    ) -> float:
        """The staleness multiplier for one parked entry.

        Default (no policy): the age rule, same arithmetic as
        ``add_stale`` — ``discount ** age``.  A drift-aware policy also
        sees how far the CURRENT base sits from the parked update,
        relative to the update's own step size at park time."""
        policy: StalenessPolicy = (
            self.staleness_policy
            if self.staleness_policy is not None
            else AgeDiscount(self.carry_discount)
        )
        drift: Optional[float] = None
        if (policy.uses_drift and base_params is not None
                and entry.origin_delta_norm is not None):
            cur = self._distance_to_base(entry.params, base_params)
            drift = cur / max(float(entry.origin_delta_norm), 1e-12)
        return policy.effective_multiplier(entry, round_idx, drift=drift)

    # ------------------------------------------------------------------
    def fold_round(
        self,
        round_idx: int,
        results: Sequence[ClientResult],
        schedule: ArrivalSchedule,
        deadline: Optional[RoundDeadline] = None,
        base_params: Any = None,
        emit_partial: bool = False,
    ) -> FoldReport:
        """Fold one round's ``c_msg_train`` messages per the schedule.

        Without a deadline (engine default and ``deadline`` both None)
        the round barriers on the round count: every deliverable silo is
        in the average.  With one, the round closes at the effective
        (quorum-extended) T_round; messages arriving later are parked in
        the carry-over buffer and folded into the *next* round's average
        with a staleness discount.  Any previously parked updates are
        drained first — they are already sitting on the server.

        ``base_params`` (the round's global weights) switches the fold to
        the aggregator's flat/delta mode — required when results carry
        :class:`~repro_torch.federated.compression.CompressedUpdate` payloads.
        A compressed update that misses the deadline is *materialized*
        (dequantized against this round's base) before it is parked: the
        delta is only meaningful against its origin round's base, which
        the next round no longer has, so the carry buffer always holds
        dense, base-independent parameters.

        ``emit_partial=True`` (a regional aggregator's partial sum) comes
        with the hierarchy, ``ROADMAP.md`` queue 1, item 13, and raises
        ``NotImplementedError`` here."""
        if emit_partial:
            raise NotImplementedError(
                "partial sums: ROADMAP.md queue 1, item 13 (hierarchy)"
            )
        deadline = deadline if deadline is not None else self.deadline
        if not results:
            raise ValueError("fold_round needs at least one client result")
        by_id = {r.client_id: r for r in results}
        arrivals = schedule.round_arrivals(round_idx, list(by_id))

        if (
            deadline is None
            and not self.carry
            and base_params is None
            and all(
                a.delay_s == 0.0 and a.revoke_at_s is None
                for a in arrivals.values()
            )
        ):
            return self._fold_degenerate(round_idx, results)

        # Final delivery times after §4.3 re-request resolution, so the
        # deadline's quorum extension can see through a revocation: a
        # re-requested silo delivers at revoke + recovery + retrain.
        t_close: Optional[float] = None
        policy_t: Optional[float] = None
        if deadline is not None:
            deliveries: Dict[str, float] = {}
            for cid, a in arrivals.items():
                if a.delivered_before_revocation():
                    deliveries[cid] = a.delay_s
                elif self.on_revocation == "rerequest" and self.max_rerequests >= 1:
                    re_t = a.rerequest_arrival(self.recovery_delay_s)
                    if math.isfinite(re_t):
                        deliveries[cid] = re_t
            weights = {cid: float(by_id[cid].n_samples) for cid in deliveries}
            policy_t = float(deadline.deadline_s(round_idx, arrivals))
            t_close = deadline.effective_deadline(
                round_idx, arrivals, deliveries, weights
            )

        agg = self.agg_engine.streaming(
            base=base_params,
            base_round=round_idx if base_params is not None else None,
            schema=self.schema if base_params is not None else None,
        )
        events: List[FoldEvent] = []
        excluded: List[str] = []
        rerequested: List[str] = []
        carried_over: List[str] = []
        carried_in: List[str] = []
        escalations: List[str] = []
        server_free = 0.0
        busy = 0.0

        # Drain last round's stragglers first: their messages are already
        # on the server (arrival 0 on this round's clock), folded with the
        # staleness discount.
        for entry in self.carry.drain():
            t0 = time.monotonic()
            mult = self._carry_multiplier(entry, round_idx, base_params)
            w_eff = float(entry.weight) * mult
            agg.add(entry.params, w_eff, block=True, client_id=entry.client_id)
            measured = time.monotonic() - t0
            cost = self.fold_cost_s if self.fold_cost_s is not None else measured
            start = server_free
            server_free = start + cost
            busy += cost
            carried_in.append(entry.client_id)
            events.append(
                FoldEvent(entry.client_id, 0.0, start, server_free,
                          weight=entry.weight, folded_weight=w_eff,
                          origin_round=entry.origin_round)
            )
            self.bus.publish(
                UpdateFolded(server_free, round_idx, entry.client_id,
                             entry.weight, w_eff,
                             origin_round=entry.origin_round)
            )

        # Event heap: (effective arrival, seq, client_id, attempt, revoke_at).
        heap: List[Any] = []
        for seq, (cid, a) in enumerate(arrivals.items()):
            heapq.heappush(heap, (a.delay_s, seq, cid, 1, a.revoke_at_s))
        seq = len(heap)

        while heap:
            arrival, _, cid, attempt, revoke_at = heapq.heappop(heap)
            if revoke_at is not None and revoke_at <= arrival:
                # The silo died before its message landed: §4.3 recovery.
                self.bus.publish(
                    RevocationOccurred(revoke_at, cid, round_idx=round_idx)
                )
                if self.on_revocation == "rerequest" and attempt <= self.max_rerequests:
                    re_arrival = arrivals[cid].rerequest_arrival(
                        self.recovery_delay_s
                    )
                    if math.isinf(re_arrival):
                        # Recorded recovery (live transport): the
                        # re-request never landed inside the horizon.
                        excluded.append(cid)
                        continue
                    heapq.heappush(heap, (re_arrival, seq, cid, attempt + 1, None))
                    seq += 1
                    rerequested.append(cid)
                else:
                    excluded.append(cid)
                continue

            self.bus.publish(UpdateArrived(arrival, round_idx, cid, attempt))
            res = by_id[cid]
            if t_close is not None and arrival > t_close:
                # Missed the (quorum-extended) deadline: park the update
                # for the next round's discounted average and advance the
                # silo's miss streak toward §4.4 escalation.
                park_params = res.params
                if isinstance(park_params, CompressedUpdate):
                    # A compressed delta is pinned to THIS round's base;
                    # the next round's aggregator has a different one.
                    # Materialize now, while the origin base is on hand.
                    park_params = materialize_update(base_params, park_params)
                elif isinstance(park_params, StructuredUpdate):
                    # The same base-pinning applies per group: materialize
                    # to {group: raw fp32 values} before parking.
                    park_params = materialize_structured(
                        base_params, park_params, self._resolve_schema(base_params))
                self.carry.defer(
                    CarryEntry(cid, park_params, float(res.n_samples),
                               origin_round=round_idx,
                               late_by_s=arrival - t_close,
                               origin_delta_norm=self._park_delta_norm(
                                   park_params, base_params))
                )
                carried_over.append(cid)
                streak = self.stragglers.record_miss(cid)
                if streak is not None:
                    escalations.append(cid)
                    self.bus.publish(
                        StragglerEscalated(arrival, cid, round_idx=round_idx,
                                           consecutive_misses=streak)
                    )
                continue

            t0 = time.monotonic()
            agg.add(res.params, res.n_samples, block=True, client_id=cid)
            measured = time.monotonic() - t0
            cost = self.fold_cost_s if self.fold_cost_s is not None else measured
            start = max(arrival, server_free)
            end = start + cost
            server_free = end
            busy += cost
            if t_close is not None:
                self.stragglers.clear(cid)
            events.append(
                FoldEvent(cid, arrival, start, end, attempt=attempt,
                          revoked_at_s=revoke_at,
                          weight=float(res.n_samples),
                          folded_weight=float(res.n_samples))
            )
            self.bus.publish(
                UpdateFolded(end, round_idx, cid,
                             float(res.n_samples), float(res.n_samples))
            )

        if not events:
            raise ValueError(
                "every silo's update was revoked and excluded; nothing to fold"
            )

        t0 = time.monotonic()
        params = agg.result()
        synchronize(tree_device(params))
        finalize = (time.monotonic() - t0) if self.fold_cost_s is None else 0.0
        busy += finalize
        span = server_free + finalize
        if t_close is not None and carried_over:
            # The server cannot close a partial round before T_round — a
            # missing message could still land until then.
            span = max(server_free, t_close) + finalize
        last_arrival = max(e.arrival_s for e in events)
        if t_close is not None and carried_over:
            # Counterfactual barrier-on-count for THIS round's messages
            # only: wait for the last deliverable one (the deferred
            # stragglers included), then fold them all.  Carried-in folds
            # are excluded — the counterfactual barrier paid those in
            # their origin round — so each deferred fold is counted
            # exactly once across a run (here, at the mean measured fold
            # cost).
            fold_costs = [e.fold_end_s - e.fold_start_s for e in events]
            mean_cost = sum(fold_costs) / max(1, len(fold_costs))
            fresh_busy = finalize + sum(
                e.fold_end_s - e.fold_start_s for e in events if not e.is_stale
            )
            barrier_span = (
                max(deliveries.values())
                + fresh_busy + len(carried_over) * mean_cost
            )
        else:
            # A barrier server waits for the last arrival, then does the
            # same total aggregation work in one go.
            barrier_span = last_arrival + busy
        if t_close is not None:
            on_time = tuple(e.client_id for e in events if not e.is_stale)
            self.bus.publish(
                DeadlineExpired(t_close, round_idx, t_close,
                                policy_t if policy_t is not None else t_close,
                                on_time, tuple(carried_over))
            )
        self.bus.publish(
            RoundClosed(span, round_idx, span,
                        tuple(carried_over), tuple(carried_in))
        )
        return FoldReport(
            params=params,
            events=events,
            excluded=excluded,
            rerequested=rerequested,
            fold_times={e.client_id: e.fold_end_s for e in events},
            round_span_s=span,
            busy_s=busy,
            idle_s=max(0.0, span - busy),
            barrier_span_s=barrier_span,
            deadline_s=t_close,
            policy_deadline_s=policy_t,
            carried_over=carried_over,
            carried_in=carried_in,
            escalations=escalations,
        )

    # ------------------------------------------------------------------
    def _fold_degenerate(
        self, round_idx: int, results: Sequence[ClientResult]
    ) -> FoldReport:
        """All messages present at dispatch: one fused batch reduce.

        This is the sync ``FLServer`` path — the barrier protocol is the
        degenerate schedule of this engine, and it keeps the flatten-once
        ``fedavg_reduce`` (better than N streaming folds when every input
        is already in memory), timed to the device's finish."""
        t0 = time.monotonic()
        params = self.agg_engine.aggregate(
            [r.params for r in results], [r.n_samples for r in results]
        )
        synchronize(tree_device(params))
        agg_s = time.monotonic() - t0
        events = [
            FoldEvent(r.client_id, 0.0, 0.0, agg_s,
                      weight=float(r.n_samples),
                      folded_weight=float(r.n_samples))
            for r in results
        ]
        for r in results:
            self.bus.publish(UpdateArrived(0.0, round_idx, r.client_id))
            self.bus.publish(
                UpdateFolded(agg_s, round_idx, r.client_id,
                             float(r.n_samples), float(r.n_samples))
            )
        self.bus.publish(RoundClosed(agg_s, round_idx, agg_s))
        return FoldReport(
            params=params,
            events=events,
            excluded=[],
            rerequested=[],
            fold_times={r.client_id: agg_s for r in results},
            round_span_s=agg_s,
            busy_s=agg_s,
            idle_s=0.0,
            barrier_span_s=agg_s,
        )


# ---------------------------------------------------------------------------
# Async server
# ---------------------------------------------------------------------------

# Imported late: server.py's sync path lazily imports this module, so a
# top-level `from .server import FLServer` here completes the cycle only
# after server.py has fully loaded.
from .server import FLServer  # noqa: E402


class AsyncFLServer(FLServer):
    """FLServer whose rounds fold ``c_msg_train`` messages as they land.

    Identical protocol and results to :class:`FLServer` (same training,
    evaluation, checkpointing, and fault-hook semantics) but the
    aggregation phase runs through :class:`AsyncRoundEngine` with a
    pluggable :class:`ArrivalSchedule`, so round records carry per-client
    fold timestamps, the server's busy/idle split, and the counterfactual
    barrier span.

    ``round_deadline`` turns on deadline-driven partial rounds: rounds
    close at the policy's (quorum-extended) T_round, late silos carry
    into the next round's discounted average, and each §4.4 escalation
    (a silo with ``escalate_after`` consecutive misses) is published as
    a :class:`~repro_torch.core.events.StragglerEscalated` event on the
    server's control-plane bus.  ``on_straggler(client_id, round_idx)``
    is a convenience hook invoked after each fold with *this server's*
    escalations — wire it to ``DynamicScheduler.select_instance`` to
    reassign the slow silo's VM; subscribe to the bus directly for the
    full typed trace (the same vocabulary the simulator emits).
    """

    def __init__(
        self,
        clients: Sequence[Any],
        initial_params: Any,
        schedule: Optional[ArrivalSchedule] = None,
        on_revocation: str = "rerequest",
        recovery_delay_s: float = 0.0,
        max_rerequests: int = 1,
        fold_cost_s: Optional[float] = None,
        round_deadline: Optional[RoundDeadline] = None,
        carry_discount: float = 0.5,
        escalate_after: int = 2,
        on_straggler: Optional[Any] = None,
        compression: Optional[Any] = None,
        schema: Union[None, UpdateSchema, Mapping[str, Any]] = None,
        staleness_policy: Optional[StalenessPolicy] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(clients, initial_params, **kwargs)
        self.schedule = schedule if schedule is not None else InstantSchedule()
        # `compression` turns on the compressed wire path: each client's
        # update is encoded as a quantized/sparsified delta against the
        # round's global weights (with per-client error feedback) and
        # folded via the aggregator's fused dequantize-and-fold path —
        # the virtual-clock twin of the live transport's worker-side
        # encoding, producing bit-identical updates for parity.
        self._compression = parse_compression(compression)
        self._compressors: Dict[str, ClientCompressor] = {}
        # `schema` turns on structured updates: each client's update is
        # re-encoded as a StructuredUpdate carrying only the schema's
        # named groups (per-group error feedback when compression is also
        # on), folded through the per-group aggregator.
        self._schema = as_update_schema(schema)
        self._struct_encoders: Dict[str, StructuredCompressor] = {}
        self._round_engine = AsyncRoundEngine(
            self.agg_engine,
            on_revocation=on_revocation,
            recovery_delay_s=recovery_delay_s,
            max_rerequests=max_rerequests,
            fold_cost_s=fold_cost_s,
            deadline=round_deadline,
            carry_discount=carry_discount,
            escalate_after=escalate_after,
            bus=self.bus,
            schema=self._schema,
            staleness_policy=staleness_policy,
        )
        self.on_straggler = on_straggler
        self.fold_reports: List[FoldReport] = []

    @property
    def pending_carryover(self) -> CarryOverBuffer:
        """Late updates parked for the next round (empty without deadlines)."""
        return self._round_engine.carry

    def _compressor_for(self, client_id: str) -> Any:
        """The client's own compressor when it has one (client-owned
        error-feedback residual), else a server-held per-client one."""
        for c in self.clients:
            if str(c.client_id) == client_id:
                owned = getattr(c, "compressor", None)
                if owned is not None:
                    return owned
                break
        return self._compressors.setdefault(
            client_id, ClientCompressor(self._compression)
        )

    def _structured_encoder_for(self, client_id: str) -> StructuredCompressor:
        """Per-client structured encoder (holds per-group error feedback)."""
        enc = self._struct_encoders.get(client_id)
        if enc is None:
            enc = StructuredCompressor(self._schema, self._compression)
            self._struct_encoders[client_id] = enc
        return enc

    def _fold_phase(self, round_idx: int, results: Sequence[ClientResult]) -> FoldReport:
        base = None
        if self._schema is not None:
            # Structured rounds: clients ship only the schema's named
            # groups.  self.params is still the dispatched global weights
            # (updated only after the fold), so it is both the encoding
            # base and the aggregation base.
            base = self.params
            results = [
                dataclasses.replace(
                    r,
                    params=self._structured_encoder_for(r.client_id).encode(
                        base, r.params, base_round=round_idx
                    ),
                )
                for r in results
            ]
        elif self._compression is not None:
            # self.params is still the round's dispatched global weights
            # here (updated only after the fold), so it is both the delta
            # base for encoding and the aggregation base for folding.
            base = self.params
            results = [
                dataclasses.replace(
                    r,
                    params=self._compressor_for(r.client_id).encode(
                        base, r.params, base_round=round_idx
                    ),
                )
                for r in results
            ]
        report = self._round_engine.fold_round(
            round_idx, results, self.schedule, base_params=base
        )
        self.fold_reports.append(report)
        # §4.4 escalation decisions are made by the control plane's
        # shared StragglerTracker and published as StragglerEscalated on
        # the bus (subscribe there for the typed trace).  The
        # on_straggler convenience hook is delivered from THIS server's
        # report — no bus subscription, so servers sharing a bus never
        # cross-dispatch each other's escalations, nothing pins the
        # server to a long-lived bus, a NULL_BUS (tracing off) still
        # recovers, and the hook fires after the round's FoldReport is
        # visible in fold_reports.
        if self.on_straggler is not None:
            for cid in report.escalations:
                self.on_straggler(cid, round_idx)
        return report
