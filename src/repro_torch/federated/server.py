"""FL server: round orchestration per the paper's §3 protocol.

The port of ``repro/federated/server.py``.  Each round:
  training phase   — send s_msg_train (current weights) to every client;
                     each trains locally and returns c_msg_train; the
                     server aggregates (FedAvg) through the
                     `AggregationEngine`: one flatten, one `fedavg_reduce`
                     kernel launch per round on the card.
  evaluation phase — send s_msg_aggreg (aggregated weights); clients
                     evaluate and return c_msg_test metrics; the server
                     aggregates metrics and starts the next round.

Cross-silo semantics: the server *always waits for all clients* before the
next round (paper §4.3).  Checkpointing follows §4.3: server checkpoint
every X rounds with async off-VM transfer; clients store the aggregated
weights each round.  The `fault_hook` lets tests revoke tasks
mid-execution; recovery uses `resolve_freshest`.  Where the reference
blocks on its arrays, the port synchronizes the device, so
``agg_time_s`` is device time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from ..checkpoint import ClientCheckpointManager, ServerCheckpointManager, resolve_freshest
from ..core.events import CheckpointSaved, EventBus, RecoveryCompleted, RoundDispatched
from ..utils.tree import tree_map
from .agg_engine import AggregationEngine
from .aggregation import aggregate_metrics
from .client import ClientResult, EvalResult, FLClient, synchronize
from .messages import RoundMessageLog, measure_messages

if TYPE_CHECKING:
    from .async_server import AsyncRoundEngine, FoldReport

Device = Union[str, torch.device]


@dataclasses.dataclass
class RoundRecord:
    round_idx: int
    train_time_s: float
    eval_time_s: float
    checkpoint_time_s: float
    metrics: Dict[str, float]
    message_log: Optional[RoundMessageLog]
    restarted_from: Optional[str] = None
    agg_time_s: float = 0.0
    # Round-engine accounting (virtual clock): per-client fold-completion
    # times, the dispatch->params span, and the server's idle share of it.
    fold_times_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    round_span_s: float = 0.0
    idle_s: float = 0.0
    deadline_s: Optional[float] = None
    carried_over: List[str] = dataclasses.field(default_factory=list)
    carried_in: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FLRunResult:
    rounds: List[RoundRecord]
    final_params: Any
    total_time_s: float

    @property
    def final_metrics(self) -> Dict[str, float]:
        return self.rounds[-1].metrics if self.rounds else {}


class FLServer:
    """The barrier FL server.  ``initial_params`` are placed on ``device``
    (default the card); the clients' results are folded there."""

    def __init__(
        self,
        clients: Sequence[FLClient],
        initial_params: Any,
        server_ckpt: Optional[ServerCheckpointManager] = None,
        client_ckpts: Optional[Dict[str, ClientCheckpointManager]] = None,
        fault_hook: Optional[Callable[[int], Optional[str]]] = None,
        measure_round_messages: bool = False,
        agg_engine: Optional[AggregationEngine] = None,
        bus: Optional[EventBus] = None,
        post_round_hook: Optional[Callable[[int, Any], Optional[Any]]] = None,
        device: Device = "cuda",
    ) -> None:
        self.clients = list(clients)
        self.device = torch.device(device)
        self.params = tree_map(lambda t: t.to(self.device), initial_params)
        self.agg_engine = agg_engine if agg_engine is not None else AggregationEngine()
        self.server_ckpt = server_ckpt
        self.client_ckpts = client_ckpts or {}
        self.fault_hook = fault_hook
        self.measure_round_messages = measure_round_messages
        self.start_round = 1
        # Server-side post-aggregation transform, called as
        # hook(round_idx, params) right after the fold; a non-None return
        # replaces the global weights before evaluation/checkpointing.
        self.post_round_hook = post_round_hook
        # One bus, one trace vocabulary: the round engine publishes
        # fold-level events on the round's virtual clock, the server
        # lifecycle events on the wall clock relative to run() start.
        self.bus = bus if bus is not None else EventBus()
        self._round_engine: Optional["AsyncRoundEngine"] = None  # built in _fold_phase
        self._wall_t0 = time.monotonic()

    def _wall(self) -> float:
        return time.monotonic() - self._wall_t0

    # ------------------------------------------------------------------
    def run(self, n_rounds: int) -> FLRunResult:
        t_start = time.monotonic()
        self._wall_t0 = t_start
        records: List[RoundRecord] = []
        r = self.start_round
        while r <= n_rounds:
            restarted_from = None
            # Fault injection point: hook returns "s" or a client id to kill.
            if self.fault_hook is not None:
                victim = self.fault_hook(r)
                if victim == "s":
                    restarted_from = self._recover_server(resume_round=r)

            self.bus.publish(RoundDispatched(self._wall(), r, len(self.clients)))
            records.append(self._run_round(r, restarted_from))
            r += 1

        if self.server_ckpt is not None:
            self.server_ckpt.wait_for_transfers()
        return FLRunResult(
            rounds=records,
            final_params=self.params,
            total_time_s=time.monotonic() - t_start,
        )

    # ------------------------------------------------------------------
    def _run_round(self, round_idx: int, restarted_from: Optional[str]) -> RoundRecord:
        # Training phase: s_msg_train -> local train -> c_msg_train.
        t0 = time.monotonic()
        results: List[ClientResult] = [c.train(self.params) for c in self.clients]
        t_agg = time.monotonic()
        fold = self._fold_phase(round_idx, results)
        self.params = fold.params
        synchronize(self.device)
        if self.post_round_hook is not None:
            merged = self.post_round_hook(round_idx, self.params)
            if merged is not None:
                self.params = merged
                synchronize(self.device)
        agg_time = time.monotonic() - t_agg
        train_time = time.monotonic() - t0

        # Evaluation phase: s_msg_aggreg -> local eval -> c_msg_test.
        t1 = time.monotonic()
        evals: List[EvalResult] = [c.evaluate(self.params) for c in self.clients]
        metrics = aggregate_metrics(
            [e.metrics for e in evals], [max(e.n_samples, 1) for e in evals]
        )
        eval_time = time.monotonic() - t1

        # Checkpointing (§4.3).  Client and server saves are timed
        # separately so each CheckpointSaved event carries only its own
        # location's overhead.
        t2 = time.monotonic()
        saved_client = False
        for c in self.clients:
            mgr = self.client_ckpts.get(c.client_id)
            if mgr is not None:
                mgr.save(round_idx, self.params)
                saved_client = True
        client_ckpt_time = time.monotonic() - t2
        t3 = time.monotonic()
        saved_server = False
        if self.server_ckpt is not None and self.server_ckpt.should_checkpoint(round_idx):
            self.server_ckpt.save(round_idx, self.params)
            saved_server = True
        server_ckpt_time = time.monotonic() - t3
        if saved_client:
            self.bus.publish(
                CheckpointSaved(self._wall(), round_idx, "client_local", client_ckpt_time)
            )
        if saved_server:
            self.bus.publish(
                CheckpointSaved(self._wall(), round_idx, "server_remote", server_ckpt_time)
            )

        log = None
        if self.measure_round_messages:
            # AsyncFLServer sets _compression when the wire path is
            # compressed and _schema when updates are structured; the log
            # then carries wire vs dense c_msg_train (and per-group maps).
            log = measure_messages(self.params, metrics,
                                   compression=getattr(self, "_compression", None),
                                   schema=getattr(self, "_schema", None))
        return RoundRecord(
            round_idx=round_idx,
            train_time_s=train_time,
            eval_time_s=eval_time,
            checkpoint_time_s=client_ckpt_time + server_ckpt_time,
            metrics=metrics,
            message_log=log,
            restarted_from=restarted_from,
            agg_time_s=agg_time,
            fold_times_s=fold.fold_times,
            round_span_s=fold.round_span_s,
            idle_s=fold.idle_s,
            deadline_s=fold.deadline_s,
            carried_over=list(fold.carried_over),
            carried_in=list(fold.carried_in),
        )

    # ------------------------------------------------------------------
    def _fold_phase(self, round_idx: int, results: Sequence[ClientResult]) -> "FoldReport":
        """Aggregate one round's c_msg_train set: the barrier protocol is
        the degenerate (all-messages-at-dispatch) schedule of the round
        engine (see async_server.AsyncFLServer for the others)."""
        # Lazy import: async_server imports FLServer from here.
        from .async_server import AsyncRoundEngine, InstantSchedule

        if self._round_engine is None:
            self._round_engine = AsyncRoundEngine(self.agg_engine, bus=self.bus)
        return self._round_engine.fold_round(round_idx, results, InstantSchedule())

    # ------------------------------------------------------------------
    def _recover_server(self, resume_round: Optional[int] = None) -> str:
        """Server VM died: restore weights from the freshest checkpoint
        (paper §4.3 rule).  Client checkpoints alone can restore the
        server ("the FL server ... waits for any client to send its
        weights").  ``resume_round`` only feeds the RecoveryCompleted
        trace event."""
        resume = resume_round if resume_round is not None else self.start_round
        if self.server_ckpt is None and not self.client_ckpts:
            source, info = "none", None
        else:
            source, info = resolve_freshest(self.server_ckpt, self.client_ckpts)
        if source == "none" or info is None:
            # No checkpoint anywhere: keep the current in-memory weights.
            self.bus.publish(RecoveryCompleted(self._wall(), "s", resume, 0.0, "none"))
            return "none"
        if source == "server":
            if self.server_ckpt is None:
                raise RuntimeError("resolve_freshest chose a server that has no manager")
            _, self.params = self.server_ckpt.restore(self.params, info)
        else:
            cid = source.split(":", 1)[1]
            _, self.params = self.client_ckpts[cid].restore(self.params)
        # The documented trace vocabulary: server_remote | client_local:<cid>.
        restored = (
            "server_remote" if source == "server"
            else f"client_local:{source.split(':', 1)[1]}"
        )
        self.bus.publish(RecoveryCompleted(self._wall(), "s", resume, 0.0, restored))
        return source
