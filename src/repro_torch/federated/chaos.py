"""Deterministic chaos engineering for the Multi-FedLS fault-tolerance story.

The port of ``repro/federated/chaos.py``: the same fault kinds, plans,
trace markers and verification, so one :class:`FaultPlan` replays on
either package's drivers and the two traces compare.  Module names in
the text below point into this package.

The paper's viability claim (§4.3 checkpoint + re-request recovery, §4.4
replacement-VM selection) is only as strong as the faults it has been
exercised against.  This module turns fault injection from hand-scripted
test scenarios into a *seeded, replayable plan*: a :class:`FaultPlan` is
a declarative set of :class:`FaultSpec` records — each targeting one
silo, one round, one phase — that the **same plan object** executes on
both control-plane drivers:

* virtual clock — :class:`ChaosSchedule` decorates any
  :class:`~repro_torch.federated.async_server.ArrivalSchedule` (the
  :class:`~repro_torch.federated.async_server.RevocationInjector` idiom) and
  rewrites the round's :class:`~repro_torch.federated.async_server.
  ClientArrival` records: crash/hang/disconnect/revocation become a
  ``revoke_at_s`` before delivery, ``slow`` adds reply delay,
  ``corrupt_frame`` revokes exactly *at* delivery (the update arrived
  but is unusable — the §4.3 re-request boundary).
* wall clock — :class:`ChaosClient` wraps a real ``FLClient`` behind
  the socket transport and executes the client-side kinds physically
  (raise, block-and-stop-heartbeats, sleep, mangle the reply bytes),
  while :class:`~repro_torch.federated.transport.LiveRoundDriver` executes
  the driver-side kinds (force-sever a connection, corrupt the newest
  checkpoint file) when constructed with ``chaos=plan``.

Every injected fault is published as a typed
:class:`~repro_torch.core.events.FaultInjected` event at the point of
injection, so the trace shows cause and §4.3/§4.4 effect side by side;
:func:`verify_fault_pairing` checks the soak invariant that every
injected fault is paired with a recovery or exclusion event, and
:func:`chaos_signature` gives the cross-driver parity view (within-round
event multisets modulo timestamps — measured arrival *order* under real
faults is scheduler noise; the strict ordered parity on fault-free and
single-fault scenarios stays pinned by ``tests/test_torch_transport.py``).

Fault kinds (:data:`FAULT_KINDS`):

====================  ======================================================
``crash``             the silo's ``train``/``evaluate`` raises (connection
                      drops: the §4.3 hard-fault signal)
``hang``              the silo blocks *and stops answering heartbeats* —
                      distinguishable from ``slow`` only by liveness
                      detection (the driver's heartbeat timeout)
``slow``              the reply is delayed by ``delay_s`` seconds (§4.4
                      straggler evidence; heartbeats keep flowing)
``disconnect``        the server-side connection is severed mid-round
``corrupt_frame``     the reply arrives but its payload is mangled — the
                      driver must treat an undecodable ``c_msg_train``
                      as a suspected fault and re-request
``corrupt_checkpoint``  the newest checkpoint file is bit-flipped /
                      truncated on disk; the §4.3 restore must fall back
                      to the newest *verified* checkpoint
``revocation``        the silo's VM is revoked; the restart may land on a
                      *different* host chosen by
                      ``DynamicScheduler.select_instance`` (§4.4 —
                      published as ``VMReplaced`` on the live driver)
====================  ======================================================
"""
from __future__ import annotations

import dataclasses
import os
import random
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from ..checkpoint.manager import _list_ckpts
from ..core.events import (
    EventBus,
    FaultInjected,
    RecoveryCompleted,
    RevocationOccurred,
    RoundClosed,
    UpdateArrived,
    UpdateFolded,
)
from .async_server import ArrivalSchedule, ClientArrival

__all__ = [
    "FAULT_KINDS",
    "ChaosClient",
    "ChaosSchedule",
    "FaultPlan",
    "FaultSpec",
    "chaos_signature",
    "checkpoint_saboteur",
    "corrupt_latest_checkpoint",
    "verify_fault_pairing",
]

FAULT_KINDS: Tuple[str, ...] = (
    "crash",
    "hang",
    "slow",
    "disconnect",
    "corrupt_frame",
    "corrupt_checkpoint",
    "revocation",
)
_PHASES: Tuple[str, ...] = ("train", "eval")

# Who executes each kind. Client kinds run inside the worker
# (ChaosClient); driver kinds are transport/filesystem actions taken by
# LiveRoundDriver.  On the virtual clock every non-checkpoint kind maps
# onto the arrival model (ChaosSchedule).
CLIENT_KINDS: Tuple[str, ...] = ("crash", "hang", "slow", "corrupt_frame")
DRIVER_KINDS: Tuple[str, ...] = ("disconnect", "revocation")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault: ``kind`` hits ``task`` in ``round_idx``/``phase``.

    ``delay_s`` is the extra reply latency of a ``slow`` fault (and the
    block duration bound of a ``hang``); ``at_s`` is the virtual-clock
    injection offset used by :class:`ChaosSchedule` (clamped to the
    victim's delivery time so the fault actually interrupts).
    """

    kind: str
    task: str
    round_idx: int
    phase: str = "train"
    delay_s: float = 0.0
    at_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}: one of {FAULT_KINDS}"
            )
        if self.phase not in _PHASES:
            raise ValueError(f"phase must be one of {_PHASES}")
        if self.round_idx < 1:
            raise ValueError("round_idx is 1-indexed: must be >= 1")
        if self.delay_s < 0.0 or self.at_s < 0.0:
            raise ValueError("delay_s and at_s must be >= 0")

    @property
    def key(self) -> Tuple[str, str, int, str]:
        return (self.kind, self.task, self.round_idx, self.phase)


class FaultPlan:
    """A deterministic, seeded set of faults — one plan, every driver.

    Faults are kept in a canonical order (round, phase, task, kind) so
    injection order — and therefore the published ``FaultInjected``
    sequence — is identical on every driver and every replay.
    """

    def __init__(self, faults: Iterable[FaultSpec], seed: int = 0) -> None:
        ordered = sorted(
            faults, key=lambda f: (f.round_idx, f.phase, f.task, f.kind)
        )
        seen: Set[Tuple[str, str, int, str]] = set()
        for f in ordered:
            if f.key in seen:
                raise ValueError(f"duplicate fault {f.key}")
            seen.add(f.key)
        self.faults: Tuple[FaultSpec, ...] = tuple(ordered)
        self.seed = int(seed)

    def __iter__(self) -> Any:
        return iter(self.faults)

    def __len__(self) -> int:
        return len(self.faults)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, FaultPlan)
            and self.faults == other.faults
            and self.seed == other.seed
        )

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, faults={list(self.faults)!r})"

    @property
    def kinds(self) -> Set[str]:
        return {f.kind for f in self.faults}

    @property
    def max_round(self) -> int:
        return max((f.round_idx for f in self.faults), default=0)

    def faults_for(
        self,
        round_idx: int,
        phase: Optional[str] = None,
        task: Optional[str] = None,
    ) -> Tuple[FaultSpec, ...]:
        return tuple(
            f
            for f in self.faults
            if f.round_idx == round_idx
            and (phase is None or f.phase == phase)
            and (task is None or f.task == task)
        )

    def wrap_clients(self, clients: Sequence[Any]) -> List["ChaosClient"]:
        """Wrap live ``FLClient`` objects so the plan's client-side kinds
        execute physically inside their workers."""
        return [ChaosClient(c, self) for c in clients]

    @classmethod
    def seeded(
        cls,
        seed: int,
        *,
        n_rounds: int,
        tasks: Sequence[str],
        kinds: Sequence[str] = CLIENT_KINDS + DRIVER_KINDS,
        n_faults: int = 4,
        slow_delay_s: float = 0.25,
    ) -> "FaultPlan":
        """Draw a deterministic multi-fault plan from a seed.

        Same ``(seed, n_rounds, tasks, kinds, n_faults)`` always yields
        the same plan — the replayability contract chaos soaks rely on.
        """
        if not tasks:
            raise ValueError("tasks must be non-empty")
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        rng = random.Random(int(seed))
        universe = [
            (r, t, k)
            for r in range(1, n_rounds + 1)
            for t in tasks
            for k in kinds
        ]
        if n_faults > len(universe):
            raise ValueError(
                f"n_faults={n_faults} exceeds the {len(universe)} distinct "
                "(round, task, kind) combinations"
            )
        picks = rng.sample(universe, n_faults)
        faults = [
            FaultSpec(
                kind=k,
                task=t,
                round_idx=r,
                delay_s=slow_delay_s if k in ("slow", "hang") else 0.0,
            )
            for r, t, k in picks
        ]
        return cls(faults, seed=seed)


# ---------------------------------------------------------------------------
# Virtual-clock execution: the arrival-model view of a plan
# ---------------------------------------------------------------------------

class ChaosSchedule(ArrivalSchedule):
    """Execute a :class:`FaultPlan` on the virtual-clock arrival model.

    Decorates any inner schedule (like ``RevocationInjector``) and, per
    round, publishes one ``FaultInjected`` marker per planned fault (in
    plan order — matching where the live driver publishes its markers)
    and rewrites the train-phase arrivals:

    * ``crash`` / ``hang`` / ``disconnect`` / ``revocation`` — revoked at
      ``min(at_s, delay_s)``: the update is lost before delivery and the
      engine's §4.3 re-request-or-exclude machinery takes over.  (The
      virtual clock cannot distinguish these kinds — they differ only in
      *how* the live transport observes them.)
    * ``slow`` — ``delay_s`` is added to the reply latency.
    * ``corrupt_frame`` — revoked exactly **at** delivery: the message
      arrived but is unusable, so recovery costs a full re-request.

    Eval-phase and ``corrupt_checkpoint`` faults don't touch arrivals
    (eval is metrics-only on the virtual clock; checkpoint sabotage is
    :func:`checkpoint_saboteur`'s job) — eval-phase markers are still
    published so traces stay comparable across drivers.
    """

    def __init__(
        self,
        inner: ArrivalSchedule,
        plan: FaultPlan,
        bus: Optional[EventBus] = None,
    ) -> None:
        self.inner = inner
        self.plan = plan
        self.bus = bus

    def round_arrivals(
        self, round_idx: int, client_ids: Sequence[str]
    ) -> Dict[str, ClientArrival]:
        arrivals = dict(self.inner.round_arrivals(round_idx, client_ids))
        for f in self.plan.faults_for(round_idx):
            if f.kind == "corrupt_checkpoint":
                continue  # marker comes from checkpoint_saboteur
            if self.bus is not None:
                self.bus.publish(
                    FaultInjected(f.at_s, f.kind, f.task, round_idx, f.phase)
                )
            if f.phase != "train" or f.task not in arrivals:
                continue
            a = arrivals[f.task]
            if f.kind == "slow":
                arrivals[f.task] = dataclasses.replace(
                    a, delay_s=a.delay_s + f.delay_s
                )
            elif f.kind == "corrupt_frame":
                arrivals[f.task] = dataclasses.replace(
                    a, revoke_at_s=a.delay_s
                )
            else:  # crash | hang | disconnect | revocation
                arrivals[f.task] = dataclasses.replace(
                    a, revoke_at_s=min(f.at_s, a.delay_s)
                )
        return arrivals


# ---------------------------------------------------------------------------
# Wall-clock execution: the worker-side view of a plan
# ---------------------------------------------------------------------------

class ChaosFault(RuntimeError):
    """Raised by :class:`ChaosClient` to execute a ``crash`` fault."""


class ChaosClient:
    """Duck-typed ``FLClient`` wrapper executing client-side fault kinds.

    The socket worker loop (:func:`~repro_torch.federated.transport.
    run_client_worker`) recognizes three optional hooks, all provided
    here: ``on_round(round_idx, phase)`` arms the wrapper before each
    compute, ``heartbeat_ok()`` gates ping replies (False while a hang
    fault is active, so the driver's liveness detector can tell a hang
    from a merely slow silo), and ``mangle_payload(body)`` corrupts the
    serialized reply bytes for a ``corrupt_frame`` fault.

    Each fault fires **once** per (kind, task, round, phase) — a §4.3
    re-request after the fault therefore succeeds, exactly like a
    replacement VM rejoining.  The same wrapper object survives worker
    restarts (thread pools respawn over the same client), which is what
    carries the fired-set across attempts.
    """

    def __init__(self, inner: Any, plan: FaultPlan, hang_s: float = 30.0) -> None:
        import threading

        self.inner = inner
        self.plan = plan
        self.hang_s = hang_s
        self._fired: Set[Tuple[str, str, int, str]] = set()
        self._round = 0
        self._phase = "train"
        self._hung = threading.Event()
        self._released = threading.Event()
        self._lock = threading.Lock()

    @property
    def client_id(self) -> Any:
        return self.inner.client_id

    # -- worker hooks ------------------------------------------------------
    def on_round(self, round_idx: int, phase: str) -> None:
        with self._lock:
            self._round = int(round_idx)
            self._phase = phase
            # A restarted worker thread must answer heartbeats again:
            # the hang that killed its predecessor has already fired.
            self._hung.clear()

    def heartbeat_ok(self) -> bool:
        return not self._hung.is_set()

    def release(self) -> None:
        """Wake any thread stuck in a hang fault (pool shutdown calls
        this so orphaned compute threads don't outlive the driver)."""
        self._released.set()

    def mangle_payload(self, body: bytes) -> bytes:
        f = self._take("corrupt_frame")
        if f is None:
            return body
        # Truncate to half: undecodable by any framing, deterministic.
        return body[: max(1, len(body) // 2)]

    # -- FLClient surface --------------------------------------------------
    def train(self, global_params: Any) -> Any:
        self._apply()
        return self.inner.train(global_params)

    def evaluate(self, aggregated_params: Any) -> Any:
        self._apply()
        return self.inner.evaluate(aggregated_params)

    # -- internals ---------------------------------------------------------
    def _take(self, *kinds: str) -> Optional[FaultSpec]:
        with self._lock:
            for f in self.plan.faults_for(self._round, self._phase,
                                          str(self.client_id)):
                if f.kind in kinds and f.key not in self._fired:
                    self._fired.add(f.key)
                    return f
        return None

    def _apply(self) -> None:
        import time

        f = self._take("crash", "hang", "slow")
        if f is None:
            return
        if f.kind == "crash":
            raise ChaosFault(
                f"injected crash: {self.client_id} round {f.round_idx}"
            )
        if f.kind == "hang":
            # Block silently and stop answering heartbeats.  The bound
            # (or a pool-shutdown release()) exists only so the orphaned
            # thread eventually dies; the driver's heartbeat timeout is
            # what actually notices.
            self._hung.set()
            self._released.wait(max(self.hang_s, f.delay_s))
            raise ChaosFault(
                f"injected hang expired: {self.client_id} round {f.round_idx}"
            )
        # slow: delay the reply, heartbeats keep flowing.
        time.sleep(f.delay_s)


# ---------------------------------------------------------------------------
# Checkpoint sabotage (corrupt_checkpoint, both drivers)
# ---------------------------------------------------------------------------

def corrupt_latest_checkpoint(server_ckpt: Any) -> List[str]:
    """Truncate the newest checkpoint file on *every* replica.

    Hits the same ``round_N.ckpt`` in both the local and the remote
    (durable) directory — corrupting only one replica would let restore
    trivially read the twin; hitting both is what forces the §4.3
    fallback to the newest *verified* (older or client-side) checkpoint.
    Returns the corrupted paths (empty when nothing is saved yet).
    """
    dirs = [
        d
        for d in (
            getattr(server_ckpt, "remote_dir", None),
            getattr(server_ckpt, "local_dir", None),
        )
        if d
    ]
    newest: Optional[str] = None
    newest_round = -1
    for d in dirs:
        for ck in _list_ckpts(d):
            if ck.round_idx > newest_round:
                newest_round = ck.round_idx
                newest = os.path.basename(ck.path)
    if newest is None:
        return []
    corrupted: List[str] = []
    for d in dirs:
        path = os.path.join(d, newest)
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(blob[: len(blob) // 2])
        corrupted.append(path)
    return corrupted


def checkpoint_saboteur(
    plan: FaultPlan,
    server_ckpt: Any,
    bus: EventBus,
) -> Callable[[int], Optional[str]]:
    """Build an ``FLServer``-compatible ``fault_hook`` executing the
    plan's ``corrupt_checkpoint`` faults on the virtual-clock driver.

    At each planned round the hook publishes the ``FaultInjected``
    marker, corrupts the newest checkpoint on disk, and returns ``"s"``
    so the server runs its §4.3 restore — which must fall back past the
    corruption to the newest verified source (``RecoveryCompleted`` in
    the trace records where it actually restored from).
    """
    fired: Set[Tuple[str, str, int, str]] = set()

    def hook(round_idx: int) -> Optional[str]:
        victim: Optional[str] = None
        for f in plan.faults_for(round_idx):
            if f.kind != "corrupt_checkpoint" or f.key in fired:
                continue
            fired.add(f.key)
            bus.publish(
                FaultInjected(f.at_s, f.kind, f.task, round_idx, f.phase)
            )
            corrupt_latest_checkpoint(server_ckpt)
            victim = "s"
        return victim

    return hook


# ---------------------------------------------------------------------------
# Trace verification: pairing + cross-driver parity
# ---------------------------------------------------------------------------

def verify_fault_pairing(
    plan: FaultPlan, trace: Sequence[Any]
) -> Dict[Tuple[str, str, int, str], str]:
    """Map every planned fault to its recovery/exclusion evidence.

    Outcomes (the soak invariant is "no ``unpaired`` values"):

    * ``recovered`` — a same-round ``RevocationOccurred`` followed by an
      attempt>=2 ``UpdateArrived`` (§4.3 re-request landed);
    * ``excluded`` — ``RevocationOccurred`` with no recovery arrival
      (§4.3 budget exhausted / reply timeout);
    * ``delivered`` — the update still folded into its round (a ``slow``
      fault that stayed inside the horizon);
    * ``carried`` — parked by a deadline and folded stale (PR 3);
    * ``restored`` — a ``corrupt_checkpoint`` answered by a
      ``RecoveryCompleted`` for the server;
    * ``metrics-only`` — an eval-phase fault (costs this round's metrics
      only; cohort retention is driver state, not trace state);
    * ``unpaired`` — the marker or its recovery evidence is missing.
    """
    out: Dict[Tuple[str, str, int, str], str] = {}
    markers = {
        (e.kind, e.task, e.round_idx, e.phase)
        for e in trace
        if isinstance(e, FaultInjected)
    }
    for f in plan.faults:
        if f.key not in markers:
            out[f.key] = "unpaired"
            continue
        if f.kind == "corrupt_checkpoint":
            restored = any(
                isinstance(e, RecoveryCompleted)
                and e.task == "s"
                and e.resume_round == f.round_idx
                for e in trace
            )
            out[f.key] = "restored" if restored else "unpaired"
            continue
        if f.phase == "eval":
            out[f.key] = "metrics-only"
            continue
        revoked = any(
            isinstance(e, RevocationOccurred)
            and e.task == f.task
            and e.round_idx == f.round_idx
            for e in trace
        )
        recovered = any(
            isinstance(e, UpdateArrived)
            and e.task == f.task
            and e.round_idx == f.round_idx
            and e.attempt >= 2
            for e in trace
        )
        delivered = any(
            isinstance(e, UpdateFolded)
            and e.task == f.task
            and (e.round_idx == f.round_idx or e.origin_round == f.round_idx)
            for e in trace
        )
        carried = any(
            isinstance(e, RoundClosed)
            and e.round_idx == f.round_idx
            and f.task in e.carried_over
            for e in trace
        )
        if revoked and recovered:
            out[f.key] = "recovered"
        elif revoked:
            out[f.key] = "excluded"
        elif delivered:
            out[f.key] = "delivered"
        elif carried:
            out[f.key] = "carried"
        else:
            out[f.key] = "unpaired"
    return out


def chaos_signature(
    trace: Sequence[Any], exclude: Tuple[str, ...] = ("VMReplaced",)
) -> List[Tuple[Any, ...]]:
    """Cross-driver parity view of a chaotic trace.

    Events are reduced to ``(type, round, task, attempt, kind)`` tuples
    and sorted *within each round segment* (a segment ends at the
    round's ``RoundClosed``): under real multi-fault load, measured
    arrival order within a round is scheduler noise, but the per-round
    event multiset — who arrived, with what attempt number, what was
    revoked, folded, carried — must match the virtual-clock replay
    exactly.  ``VMReplaced`` is excluded by default: placement is
    live-driver state (the virtual driver has no host map).
    """
    sig: List[Tuple[Any, ...]] = []
    segment: List[Tuple[Any, ...]] = []
    for e in trace:
        name = type(e).__name__
        if name in exclude:
            continue
        entry = (
            name,
            getattr(e, "round_idx", None),
            getattr(e, "task", None),
            getattr(e, "attempt", None),
            getattr(e, "kind", None),
        )
        segment.append(entry)
        if name == "RoundClosed":
            sig.extend(sorted(segment, key=lambda t: tuple(map(repr, t))))
            segment = []
    sig.extend(sorted(segment, key=lambda t: tuple(map(repr, t))))
    return sig
