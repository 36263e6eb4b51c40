"""Fault Tolerance module (paper §4.3).

This is the port's own copy of ``repro/core/fault_tolerance.py``, which uses no JAX:
the same classes, fields and arithmetic, so both packages' schedulers
make the same decisions.  The port imports nothing of the JAX package;
the text below is the reference's, and its module names point into
that package.

Responsibilities:
  * checkpoint policy — the server checkpoints its aggregated model every X
    rounds and asynchronously ships the file off-VM; every client stores the
    aggregated weights it receives each round on local disk;
  * task monitoring — observe task health, detect revocations/faults;
  * recovery orchestration — on a fault, ask the Dynamic Scheduler for a
    replacement VM, restore from the freshest checkpoint (server's if newer,
    otherwise any client's), relaunch, resume monitoring.  A silo that
    repeatedly misses round deadlines (T_round partial rounds, §4.4) is a
    *soft* fault: `handle_straggler` routes it through the same scheduler
    without a checkpoint restore.

The module is runtime-agnostic: the event-driven simulator drives it with
simulated clock/events, and `repro.federated.server` drives it with real
training state (JAX pytrees serialized via `repro.checkpoint`).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from .cost_model import SERVER, Assignment, Placement
from .dynamic_scheduler import DynamicScheduler, ReplacementDecision
from .events import EventBus, PriceUpdated, RevocationOccurred


class TaskState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    FAULTY = "faulty"
    FINISHED = "finished"


@dataclasses.dataclass
class CheckpointPolicy:
    """Server checkpoints every `server_interval_rounds`; clients keep the
    aggregated weights of every round locally (`client_every_round`)."""

    server_interval_rounds: int = 10
    client_every_round: bool = True
    # Local-disk write bandwidth used to model save overhead (bytes/s).
    disk_bandwidth_Bps: float = 200e6
    # Off-VM async transfer bandwidth (bytes/s); overlaps server wait time so
    # it only delays recovery, not the round (paper §5.5 observation).
    transfer_bandwidth_Bps: float = 50e6

    def server_checkpoints_at(self, round_idx: int) -> bool:
        """Rounds are 1-indexed; checkpoint at X, 2X, 3X, ..."""
        return self.server_interval_rounds > 0 and round_idx % self.server_interval_rounds == 0

    def save_overhead_s(self, checkpoint_bytes: int) -> float:
        """Synchronous part of a checkpoint: the local-disk write."""
        if checkpoint_bytes <= 0:
            return 0.0
        return checkpoint_bytes / self.disk_bandwidth_Bps

    def transfer_time_s(self, checkpoint_bytes: int) -> float:
        if checkpoint_bytes <= 0:
            return 0.0
        return checkpoint_bytes / self.transfer_bandwidth_Bps


@dataclasses.dataclass
class RiskAwareCheckpointPolicy(CheckpointPolicy):
    """Checkpoint cadence scaled by observed revocation risk (autopilot
    part 3).

    The base class checkpoints every fixed ``server_interval_rounds``;
    here that value is the *calm-market baseline* and the live interval
    adapts between ``min_interval_rounds`` and the baseline:

      * **revocation rate** — an EWMA of inter-revocation gaps (in
        rounds) pulls the interval down to about half the expected gap,
        so at most ~half an interval of work is at risk between copies;
      * **spot prices** — an EWMA of quote/listed ratios from
        `PriceUpdated` events shortens the interval further when the
        markets the run sits on trade hot (historically correlated with
        reclaim pressure), by up to ``1/(1 + price_sensitivity)``.

    Call :meth:`attach` to subscribe the observers to a bus, or feed
    :meth:`observe_revocation` / :meth:`observe_price` directly.  The
    cadence decision itself stays in ``server_checkpoints_at`` — the
    `FaultToleranceModule` does not change."""

    min_interval_rounds: int = 1
    smoothing: float = 0.5          # EWMA weight of the newest observation
    price_sensitivity: float = 1.0  # interval shrink per unit of price heat
    # Runtime state (observed signals), not part of the policy identity.
    _mean_gap_rounds: Optional[float] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _last_revocation_round: Optional[int] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _price_ratio: float = dataclasses.field(
        default=1.0, repr=False, compare=False
    )
    _last_ckpt_round: int = dataclasses.field(
        default=0, repr=False, compare=False
    )

    def __post_init__(self) -> None:
        if self.server_interval_rounds < 1:
            raise ValueError(
                "RiskAwareCheckpointPolicy needs a baseline interval >= 1 "
                "(server_interval_rounds is the calm-market cadence)"
            )
        if not 1 <= self.min_interval_rounds <= self.server_interval_rounds:
            raise ValueError(
                "need 1 <= min_interval_rounds <= server_interval_rounds"
            )
        if not 0.0 < self.smoothing <= 1.0:
            raise ValueError("smoothing must be in (0, 1]")
        if self.price_sensitivity < 0.0:
            raise ValueError("price_sensitivity must be >= 0")

    # -- observed signals ---------------------------------------------------
    def observe_revocation(self, round_idx: int) -> None:
        """Fold one revocation into the inter-revocation-gap EWMA."""
        if self._last_revocation_round is not None:
            gap = float(max(1, round_idx - self._last_revocation_round))
            if self._mean_gap_rounds is None:
                self._mean_gap_rounds = gap
            else:
                self._mean_gap_rounds += self.smoothing * (gap - self._mean_gap_rounds)
        else:
            # First observation: rounds survived so far is the only gap
            # evidence there is.
            self._mean_gap_rounds = float(max(1, round_idx))
        self._last_revocation_round = round_idx

    def observe_price(self, quote_to_listed_ratio: float) -> None:
        """Fold one spot quote/listed ratio into the price-heat EWMA."""
        if quote_to_listed_ratio > 0.0:
            self._price_ratio += self.smoothing * (
                quote_to_listed_ratio - self._price_ratio
            )

    def attach(self, bus: EventBus) -> Callable[[], None]:
        """Subscribe the observers to ``bus``; returns an unsubscribe."""
        def on_revocation(event: object) -> None:
            assert isinstance(event, RevocationOccurred)
            self.observe_revocation(event.round_idx)

        def on_price(event: object) -> None:
            assert isinstance(event, PriceUpdated)
            self.observe_price(event.price_per_hour / event.listed_per_hour)

        unsubs = [
            bus.subscribe(RevocationOccurred, on_revocation),
            bus.subscribe(PriceUpdated, on_price),
        ]

        def unsubscribe() -> None:
            for u in unsubs:
                u()

        return unsubscribe

    # -- adaptive cadence ---------------------------------------------------
    def current_interval_rounds(self) -> int:
        """The live interval: baseline / risk, clamped to
        [min_interval_rounds, server_interval_rounds]."""
        interval = float(self.server_interval_rounds)
        if self._mean_gap_rounds is not None:
            # Checkpoint ~twice per expected inter-revocation gap.
            interval = min(interval, self._mean_gap_rounds / 2.0)
        heat = max(0.0, self._price_ratio - 1.0)
        interval /= 1.0 + self.price_sensitivity * heat
        return max(self.min_interval_rounds,
                   min(self.server_interval_rounds, round(interval)))

    def server_checkpoints_at(self, round_idx: int) -> bool:
        due = round_idx - self._last_ckpt_round >= self.current_interval_rounds()
        if due:
            self._last_ckpt_round = round_idx
        return due


@dataclasses.dataclass
class CheckpointRecord:
    round_idx: int            # last round captured by this checkpoint
    location: str             # "server_remote" | "client_local:<cid>"
    completed_at_s: float     # wall-clock time the checkpoint became durable


@dataclasses.dataclass
class RecoveryPlan:
    decision: ReplacementDecision
    restore_from: Optional[CheckpointRecord]
    resume_round: int          # first round to (re)execute after restart
    restore_transfer_s: float  # time to ship weights to the new VM


class FaultToleranceModule:
    """Monitors tasks and orchestrates recovery (paper §4.3 + Fig. 1)."""

    def __init__(
        self,
        scheduler: DynamicScheduler,
        policy: CheckpointPolicy,
        checkpoint_bytes: int,
        vm_startup_s: float = 60.0,
        remove_revoked: bool = True,
    ) -> None:
        self.scheduler = scheduler
        self.policy = policy
        self.checkpoint_bytes = checkpoint_bytes
        self.vm_startup_s = vm_startup_s
        self.remove_revoked = remove_revoked
        self.task_state: Dict[str, TaskState] = {}
        self.server_checkpoints: List[CheckpointRecord] = []
        self.client_checkpoints: Dict[str, CheckpointRecord] = {}
        self.recovery_log: List[RecoveryPlan] = []

    # -- monitoring ----------------------------------------------------------
    def register_tasks(self, placement: Mapping[str, Assignment]) -> None:
        for task in placement:
            self.task_state[task] = TaskState.RUNNING

    def mark_finished(self) -> None:
        for task in self.task_state:
            self.task_state[task] = TaskState.FINISHED

    # -- checkpoint bookkeeping ------------------------------------------------
    def on_round_complete(self, round_idx: int, now_s: float) -> float:
        """Record checkpoints for a completed round; returns the synchronous
        overhead (seconds) added to the round by checkpointing."""
        overhead = 0.0
        if self.policy.client_every_round:
            # Clients write the aggregated weights they just received. This
            # happens in parallel across clients; the synchronous overhead is
            # one local write (clients do it while the server is idle).
            overhead += self.policy.save_overhead_s(self.checkpoint_bytes)
            for cid in [t for t in self.task_state if t != SERVER]:
                self.client_checkpoints[cid] = CheckpointRecord(
                    round_idx=round_idx,
                    location=f"client_local:{cid}",
                    completed_at_s=now_s,
                )
        if self.policy.server_checkpoints_at(round_idx):
            overhead += self.policy.save_overhead_s(self.checkpoint_bytes)
            # The off-VM copy is asynchronous: it becomes durable after the
            # transfer time but does not block the round.
            self.server_checkpoints.append(
                CheckpointRecord(
                    round_idx=round_idx,
                    location="server_remote",
                    completed_at_s=now_s + self.policy.transfer_time_s(self.checkpoint_bytes),
                )
            )
        return overhead

    def latest_server_checkpoint(self, now_s: float) -> Optional[CheckpointRecord]:
        """The freshest *durable* server checkpoint at time now_s."""
        durable = [c for c in self.server_checkpoints if c.completed_at_s <= now_s]
        return durable[-1] if durable else None

    def latest_client_checkpoint(self, exclude: Optional[str] = None) -> Optional[CheckpointRecord]:
        recs = [r for cid, r in self.client_checkpoints.items() if cid != exclude]
        if not recs:
            return None
        return max(recs, key=lambda r: r.round_idx)

    # -- recovery ----------------------------------------------------------------
    def handle_fault(
        self,
        faulty_task: str,
        current_placement: Placement,
        revoked_vm: str,
        now_s: float,
        current_round: int,
    ) -> RecoveryPlan:
        """Select a replacement VM and decide where to restore from.

        Returns the plan; the caller (simulator or live runtime) applies it
        (updates the placement, charges startup/restore time, re-runs rounds).
        """
        self.task_state[faulty_task] = TaskState.FAULTY
        decision = self.scheduler.select_instance(
            faulty_task,
            current_placement,
            revoked_vm,
            remove_revoked=self.remove_revoked,
            now_s=now_s,
        )

        restore_from: Optional[CheckpointRecord] = None
        restore_transfer_s = 0.0
        if faulty_task == SERVER:
            # Freshest of {durable server checkpoint, any client's local copy}
            # (paper: "verify if the server or the clients have the latest
            # checkpoint").
            server_ck = self.latest_server_checkpoint(now_s)
            client_ck = self.latest_client_checkpoint()
            if server_ck is not None and (
                client_ck is None or server_ck.round_idx >= client_ck.round_idx
            ):
                restore_from = server_ck
            else:
                restore_from = client_ck
            if restore_from is not None:
                restore_transfer_s = self.policy.transfer_time_s(self.checkpoint_bytes)
            resume_round = (restore_from.round_idx + 1) if restore_from else 1
        else:
            # A client restart needs no weight upload: the server re-sends the
            # current weights at the start of the round it re-executes.
            restore_from = self.client_checkpoints.get(faulty_task)
            resume_round = current_round

        plan = RecoveryPlan(
            decision=decision,
            restore_from=restore_from,
            resume_round=resume_round,
            restore_transfer_s=restore_transfer_s,
        )
        self.recovery_log.append(plan)
        self.task_state[faulty_task] = TaskState.RUNNING
        return plan

    def handle_straggler(
        self,
        slow_task: str,
        current_placement: Placement,
        slow_vm: str,
        now_s: float,
        current_round: int,
    ) -> RecoveryPlan:
        """§4.4 soft fault: a silo repeatedly missing round deadlines.

        The VM is alive — no checkpoint restore is needed (the server
        re-sends the current weights with the next ``s_msg_train``) — but
        it is too slow to make rounds, so the Dynamic Scheduler picks a
        replacement exactly as it would after a revocation; the slow type
        enters the same cooldown so it is not immediately re-selected.
        The silo trains the *next* round on the new VM (its current late
        update, if any, is already in the carry-over buffer)."""
        self.task_state[slow_task] = TaskState.FAULTY
        decision = self.scheduler.select_instance(
            slow_task,
            current_placement,
            slow_vm,
            remove_revoked=self.remove_revoked,
            now_s=now_s,
        )
        plan = RecoveryPlan(
            decision=decision,
            restore_from=self.client_checkpoints.get(slow_task),
            resume_round=current_round + 1,
            restore_transfer_s=0.0,
        )
        self.recovery_log.append(plan)
        self.task_state[slow_task] = TaskState.RUNNING
        return plan

    def recovery_delay_s(self, plan: RecoveryPlan) -> float:
        """Wall-clock delay a fault adds before the task can re-execute."""
        return self.vm_startup_s + plan.restore_transfer_s
