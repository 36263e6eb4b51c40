"""Async round engine — the degenerate (barrier) branch.

The port of the part of ``repro/federated/async_server.py`` that the sync
:class:`~repro_torch.federated.server.FLServer` runs.  In the reference
the barrier protocol is the degenerate schedule of the async engine:
every ``c_msg_train`` is present at dispatch (:class:`InstantSchedule`),
so the round is one fused batch reduce through the
:class:`~repro_torch.federated.agg_engine.AggregationEngine`, and the
engine publishes the same fold trace (UpdateArrived, UpdateFolded,
RoundClosed) an async round would.

Every other branch of ``fold_round`` — arrivals spread in time,
revocations, deadlines, carry-over, delta bases, partial sums — raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that brings it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

from ..core.events import EventBus, RoundClosed, UpdateArrived, UpdateFolded
from .agg_engine import AggregationEngine
from .client import ClientResult, synchronize, tree_device

__all__ = [
    "ArrivalSchedule",
    "AsyncRoundEngine",
    "ClientArrival",
    "FoldEvent",
    "FoldReport",
    "InstantSchedule",
]

_LATER = (
    "ROADMAP.md queue 1, item 8 (async rounds: schedules, deadlines, "
    "carry-over, §4.3 re-request)"
)


# ---------------------------------------------------------------------------
# Arrival model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClientArrival:
    """One client's ``c_msg_train`` arrival event on the round's virtual
    clock.  (The reference's measured re-request arrival comes with the
    revocation schedules.)"""

    client_id: str
    delay_s: float                        # dispatch -> message-on-server
    revoke_at_s: Optional[float] = None   # spot VM revoked at this time


class ArrivalSchedule:
    """Maps a round to per-client arrival events (virtual seconds)."""

    def round_arrivals(
        self, round_idx: int, client_ids: Sequence[str]
    ) -> Dict[str, ClientArrival]:
        raise NotImplementedError


class InstantSchedule(ArrivalSchedule):
    """Every message is present at dispatch: the barrier server's timeline."""

    def round_arrivals(
        self, round_idx: int, client_ids: Sequence[str]
    ) -> Dict[str, ClientArrival]:
        return {cid: ClientArrival(cid, 0.0) for cid in client_ids}


# ---------------------------------------------------------------------------
# Fold accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FoldEvent:
    """One client fold on the round's virtual clock.  (Re-request attempts
    and stale folds come with the async schedules.)"""

    client_id: str
    arrival_s: float
    fold_start_s: float
    fold_end_s: float
    weight: float = 0.0         # raw example weight folded (n_samples)
    folded_weight: float = 0.0  # after staleness discount (== weight when fresh)


@dataclasses.dataclass
class FoldReport:
    """Result of one round fold: the reference's fields that the barrier
    path fills (escalations and partial sums come with their slices)."""

    params: Any
    events: List[FoldEvent]
    excluded: List[str]
    rerequested: List[str]
    fold_times: Dict[str, float]
    round_span_s: float
    busy_s: float
    idle_s: float
    barrier_span_s: float
    deadline_s: Optional[float] = None
    carried_over: List[str] = dataclasses.field(default_factory=list)
    carried_in: List[str] = dataclasses.field(default_factory=list)


class AsyncRoundEngine:
    """Folds one round's client results (degenerate schedule only).

    ``bus``: the control-plane bus the fold trace is published on (None
    creates a private recording bus)."""

    def __init__(
        self,
        agg_engine: Optional[AggregationEngine] = None,
        bus: Optional[EventBus] = None,
    ) -> None:
        self.agg_engine = agg_engine if agg_engine is not None else AggregationEngine()
        self.bus = bus if bus is not None else EventBus()

    def fold_round(
        self,
        round_idx: int,
        results: Sequence[ClientResult],
        schedule: ArrivalSchedule,
        deadline: Any = None,
        base_params: Any = None,
        emit_partial: bool = False,
    ) -> FoldReport:
        """Fold one round's ``c_msg_train`` messages per the schedule.

        Only the degenerate case runs here: no deadline, no delta base,
        no partial sum, and every message present at dispatch."""
        if not results:
            raise ValueError("fold_round needs at least one client result")
        if deadline is not None:
            raise NotImplementedError(f"deadline rounds: {_LATER}")
        if base_params is not None:
            raise NotImplementedError(
                "delta-base folds: ROADMAP.md queue 1, item 10 (compressed updates)"
            )
        if emit_partial:
            raise NotImplementedError(
                "partial sums: ROADMAP.md queue 1, item 13 (hierarchy)"
            )
        by_id = {r.client_id: r for r in results}
        arrivals = schedule.round_arrivals(round_idx, list(by_id))
        if not all(a.delay_s == 0.0 and a.revoke_at_s is None for a in arrivals.values()):
            raise NotImplementedError(f"arrivals spread in time: {_LATER}")
        return self._fold_degenerate(round_idx, results)

    def _fold_degenerate(
        self, round_idx: int, results: Sequence[ClientResult]
    ) -> FoldReport:
        """All messages present at dispatch: one fused batch reduce, timed
        to the device's finish."""
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
