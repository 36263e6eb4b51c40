"""Wall-clock socket transport: real ``FLClient`` workers as a bus driver.

The port of ``repro/federated/transport.py``.  Frames are byte for byte
the reference's (the header packed by the port's own msgpack subset), so
a worker of either package serves a driver of the other.  Each
``c_msg_train`` reply is decoded on the host and folded on the device of
the driver's weights: an int8 or fp16 update through the ``dequant_fold``
kernel on the card, one launch per folded update.  A silo's weights land
on the device of its pool's template; both pools place it on the card
unless told otherwise, and a process pool's child rebuilds it there (no
weights are pickled).  Module names in the text below point into this
package.

The paper's proof of concept (§5.7) runs Cross-Silo FL over real
networks (AWS + GCP); every other driver in this repo advances a
virtual clock.  This module closes that gap with a *third* driver of
the shared control plane: a length-prefixed loopback/TCP transport
(:class:`SocketTransport`) carrying the §3 message set — ``s_msg_train``
/ ``c_msg_train`` / ``s_msg_aggreg`` / ``c_msg_test`` — between a
:class:`LiveRoundDriver` and real ``FLClient`` workers, each running the
blocking :func:`run_client_worker` loop in its own thread
(:class:`ThreadWorkerPool`, the CI-friendly default: same wire protocol,
framing, and crash semantics, no process spawn cost) or OS process
(:class:`ProcessWorkerPool`, ``multiprocessing`` spawn).

Design rule: the live path is **just another bus driver**.  The driver
records each reply's measured wall-clock arrival offset and replays the
round through the *existing* :class:`~repro_torch.federated.async_server.
AsyncRoundEngine` via a :class:`RecordedSchedule` — so the
``StreamingAggregator`` fold path, the :class:`~repro_torch.federated.
async_server.RoundDeadline` policies (including builder-bridged
:class:`~repro_torch.federated.async_server.CallableDeadline` specs), the
carry-over buffer, §4.3 re-request-or-exclude recovery, and the §4.4
:class:`~repro_torch.core.control_plane.StragglerTracker` escalation all run
unchanged on measured times, and the bus carries the same typed
vocabulary (RoundDispatched, UpdateArrived, UpdateFolded,
RevocationOccurred, DeadlineExpired, StragglerEscalated, RoundClosed)
as the virtual-clock drivers; the parity is pinned by
``tests/test_torch_transport.py``.

Fault mapping (§4.3 / §4.4):

* **crash** — a worker whose ``train`` raises drops its connection; the
  driver sees EOF mid-round and, under ``on_revocation="rerequest"``,
  physically restarts the worker and resends ``s_msg_train``.  The
  *measured* re-arrival is replayed through the engine via
  ``ClientArrival.re_arrival_s`` (RevocationOccurred + attempt-2
  UpdateArrived in the trace).  With the re-request budget exhausted
  (or ``"exclude"``) the silo is excluded from the round and dropped
  from the cohort.
* **reply timeout** — a silo that misses ``reply_timeout_s`` is treated
  as a §4.3 suspected fault for the round (RevocationOccurred with an
  infinite recorded re-arrival => excluded) but *stays in the cohort*:
  its worker is still alive, stale replies are discarded by round tag,
  and consecutive timeouts advance the engine's shared
  ``StragglerTracker`` toward a §4.4 ``StragglerEscalated`` event and
  the ``on_straggler`` hook — the same escalation contract as
  ``AsyncFLServer``.

Communication costs (Eq. 6) are fed back from *measured* payloads: each
round's :class:`~repro_torch.federated.messages.RoundMessageLog` carries the
actual serialized byte counts seen on the wire, and an attached
``CostModel`` is updated through
:func:`~repro_torch.federated.messages.to_cost_model_sizes` after every round.
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing
import os
import queue
import random
import selectors
import socket
import struct
import threading
import time
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Mapping,
    MutableMapping,
    Optional,
    Protocol,
    Sequence,
    Set,
    Tuple,
    runtime_checkable,
)

import torch

from ..checkpoint import resolve_freshest
from ..checkpoint._msgpack import packb, unpackb
from ..checkpoint.serializer import (
    DeserializationError,
    deserialize_pytree,
    serialize_pytree,
)
from ..core.cost_model import Assignment
from ..core.events import (
    CheckpointSaved,
    EventBus,
    FaultInjected,
    RecoveryCompleted,
    RoundDispatched,
    StragglerEscalated,
    VMReplaced,
)
from ..utils.tree import tree_map
from .agg_engine import AggregationEngine
from .aggregation import aggregate_metrics
from .async_server import (
    ArrivalSchedule,
    AsyncRoundEngine,
    ClientArrival,
    FoldReport,
    RoundDeadline,
)
from .chaos import DRIVER_KINDS, FaultPlan, corrupt_latest_checkpoint
from .client import ClientResult, Device, synchronize, tree_device
from .messages import RoundMessageLog, serialize_metrics, to_cost_model_sizes
from .server import FLRunResult, RoundRecord

__all__ = [
    "LiveRoundDriver",
    "ProcessWorkerPool",
    "ReconnectPolicy",
    "RecordedSchedule",
    "SocketTransport",
    "ThreadWorkerPool",
    "TransportEvent",
    "WorkerPool",
    "run_client_worker",
]


# ---------------------------------------------------------------------------
# Wire protocol: length-prefixed frames
# ---------------------------------------------------------------------------

# Message kinds — the §3 vocabulary plus session control.
MSG_HELLO = "hello"
MSG_S_TRAIN = "s_msg_train"
MSG_C_TRAIN = "c_msg_train"
MSG_S_AGGREG = "s_msg_aggreg"
MSG_C_TEST = "c_msg_test"
MSG_SHUTDOWN = "shutdown"
# Liveness probes (server -> worker -> server).  A worker answers PING
# from its receive loop even while a train/evaluate is computing, so a
# missing PONG means the *silo* is dead or wedged — not merely slow.
MSG_PING = "ping"
MSG_PONG = "pong"

# Frame = 8-byte prefix (header length, payload length, both u32 BE)
# + msgpack header + raw payload (serialized pytree / metrics blob).
_PREFIX = struct.Struct(">II")
_RECV_CHUNK = 1 << 20


def _pack_header(header: Mapping[str, Any]) -> bytes:
    return packb(dict(header))


def _unpack_header(blob: bytes) -> Dict[str, Any]:
    out = unpackb(blob)
    if not isinstance(out, dict):
        raise ValueError(f"malformed frame header: {out!r}")
    return dict(out)


def send_frame(
    sock: socket.socket, header: Mapping[str, Any], payload: bytes = b""
) -> int:
    """Write one frame; returns the bytes put on the wire (prefix incl.).

    The payload goes out by its own ``sendall``: the bytes on the wire
    are the reference's, without first copying a weight message (656.7
    MB at the paper's FEMNIST width) into one buffer with the header."""
    head = _pack_header(header)
    sock.sendall(_PREFIX.pack(len(head), len(payload)) + head)
    if payload:
        sock.sendall(payload)
    return _PREFIX.size + len(head) + len(payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    """Blocking read of exactly n bytes; None on a clean EOF at a frame
    boundary (mid-frame EOF raises ConnectionError).

    Reads into one buffer of n bytes.  The reference's ``recv(n - got)``
    allocates the rest of the frame on every call: one 656.7 MB weight
    message took 170.6 s over loopback that way on an NVIDIA H100 host,
    and 0.6-0.7 s read into one buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, _RECV_CHUNK))
        if k == 0:
            if got == 0:
                return None
            raise ConnectionError("connection closed mid-frame")
        got += k
    return buf


def recv_frame(
    sock: socket.socket,
) -> Optional[Tuple[Dict[str, Any], bytes | bytearray]]:
    """Blocking read of one frame; None on clean EOF (peer closed).  The
    payload is a ``bytearray`` (the receive buffer itself, not a copy)."""
    prefix = _recv_exact(sock, _PREFIX.size)
    if prefix is None:
        return None
    head_len, payload_len = _PREFIX.unpack(prefix)
    head = _recv_exact(sock, head_len) if head_len else b""
    if head is None:
        raise ConnectionError("connection closed mid-frame")
    payload = _recv_exact(sock, payload_len) if payload_len else b""
    if payload is None:
        raise ConnectionError("connection closed mid-frame")
    return _unpack_header(head), payload


# ---------------------------------------------------------------------------
# Server-side transport
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransportEvent:
    """One observation from :meth:`SocketTransport.poll`.

    ``kind``: ``"message"`` (a complete frame from an identified client),
    ``"joined"`` (a worker's hello was accepted — first connect or a
    §4.3 restart rejoin), or ``"disconnect"`` (EOF/reset: the silo
    crashed or shut down).  ``wire_bytes`` counts the frame's full
    on-the-wire size (prefix + header + payload) for message events.
    """

    kind: str
    client_id: str
    header: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    payload: bytes = b""
    wire_bytes: int = 0


class _ConnState:
    """Per-connection receive buffer + incremental frame parser."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.buf = bytearray()
        self.client_id: Optional[str] = None

    def parse_frames(self) -> List[Tuple[Dict[str, Any], bytes, int]]:
        frames: List[Tuple[Dict[str, Any], bytes, int]] = []
        while len(self.buf) >= _PREFIX.size:
            head_len, payload_len = _PREFIX.unpack(bytes(self.buf[: _PREFIX.size]))
            total = _PREFIX.size + head_len + payload_len
            if len(self.buf) < total:
                break
            head = bytes(self.buf[_PREFIX.size:_PREFIX.size + head_len])
            payload = bytes(self.buf[_PREFIX.size + head_len:total])
            del self.buf[:total]
            frames.append((_unpack_header(head), payload, total))
        return frames


class SocketTransport:
    """Length-prefixed TCP transport multiplexing one server over N silos.

    The server listens on ``host:port`` (port 0 = ephemeral loopback —
    the CI default); each worker connects and identifies itself with a
    hello frame.  :meth:`poll` drives a ``selectors`` loop that accepts
    new connections (first joins and §4.3 restart rejoins alike), parses
    complete frames out of per-connection buffers, and surfaces
    disconnects — the driver's crash signal.  Sends are blocking with a
    ``send_timeout_s`` bound so a wedged silo cannot hang the server.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        send_timeout_s: float = 30.0,
    ) -> None:
        self.host = host
        self.port = port
        self.send_timeout_s = send_timeout_s
        self._listener: Optional[socket.socket] = None
        self._selector = selectors.DefaultSelector()
        self._conns: Dict[str, _ConnState] = {}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> Tuple[str, int]:
        """Bind + listen; returns the (host, port) workers connect to."""
        if self._listener is not None:
            return self.address
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self.host, self.port))
        listener.listen()
        listener.setblocking(False)
        self._listener = listener
        self._selector.register(listener, selectors.EVENT_READ, None)
        return self.address

    @property
    def address(self) -> Tuple[str, int]:
        if self._listener is None:
            raise RuntimeError("transport not started: call start() first")
        addr = self._listener.getsockname()
        return str(addr[0]), int(addr[1])

    def close(self) -> None:
        for state in list(self._conns.values()):
            self._drop(state)
        self._conns.clear()
        if self._listener is not None:
            try:
                self._selector.unregister(self._listener)
            except (KeyError, ValueError):
                pass
            self._listener.close()
            self._listener = None
        self._selector.close()

    # -- connection registry ----------------------------------------------
    @property
    def client_ids(self) -> List[str]:
        return sorted(self._conns)

    def is_live(self, client_id: str) -> bool:
        return client_id in self._conns

    def disconnect(self, client_id: str) -> bool:
        """Force-sever a silo's connection (the chaos ``disconnect`` /
        ``revocation`` faults, and the liveness detector's hang verdict).

        The worker observes EOF and dies — exactly the §4.3 crash signal
        a real revocation produces.  Returns False when the silo was not
        connected.  No ``disconnect`` TransportEvent is emitted (the
        caller initiated the drop, so it already knows)."""
        state = self._conns.get(client_id)
        if state is None:
            return False
        self._drop(state)
        return True

    def _drop(self, state: _ConnState) -> None:
        try:
            self._selector.unregister(state.sock)
        except (KeyError, ValueError):
            pass
        try:
            state.sock.close()
        except OSError:
            pass
        if state.client_id is not None and (
            self._conns.get(state.client_id) is state
        ):
            del self._conns[state.client_id]

    # -- sending -----------------------------------------------------------
    def send(
        self, client_id: str, header: Mapping[str, Any], payload: bytes = b""
    ) -> int:
        """Send one frame to a connected silo; returns wire bytes.

        Raises ``ConnectionError`` when the silo is not connected or the
        send times out / fails — callers map that onto the §4.3 crash
        path exactly like an EOF."""
        state = self._conns.get(client_id)
        if state is None:
            raise ConnectionError(f"client {client_id!r} is not connected")
        sock = state.sock
        try:
            sock.settimeout(self.send_timeout_s)
            return send_frame(sock, header, payload)
        except (OSError, socket.timeout) as exc:
            self._drop(state)
            raise ConnectionError(
                f"send to client {client_id!r} failed: {exc}"
            ) from exc
        finally:
            try:
                sock.setblocking(False)
            except OSError:
                pass

    # -- polling -----------------------------------------------------------
    def poll(self, timeout_s: Optional[float]) -> List[TransportEvent]:
        """Advance the selector loop once; returns all transport events
        observed (possibly none on timeout)."""
        if self._listener is None:
            raise RuntimeError("transport not started: call start() first")
        events: List[TransportEvent] = []
        for key, _mask in self._selector.select(timeout_s):
            if key.data is None:  # the listener
                self._accept(events)
            else:
                self._read(key.data, events)
        return events

    def _accept(self, events: List[TransportEvent]) -> None:
        assert self._listener is not None
        while True:
            try:
                conn, _addr = self._listener.accept()
            except BlockingIOError:
                return
            conn.setblocking(False)
            state = _ConnState(conn)
            self._selector.register(conn, selectors.EVENT_READ, state)

    def _read(self, state: _ConnState, events: List[TransportEvent]) -> None:
        closed = False
        try:
            chunk = state.sock.recv(_RECV_CHUNK)
            if not chunk:
                closed = True
            else:
                state.buf.extend(chunk)
        except BlockingIOError:
            return
        except OSError:
            closed = True

        for header, payload, wire in state.parse_frames():
            if state.client_id is None:
                if header.get("kind") != MSG_HELLO or "client_id" not in header:
                    closed = True
                    break
                cid = str(header["client_id"])
                state.client_id = cid
                stale = self._conns.get(cid)
                if stale is not None and stale is not state:
                    self._drop(stale)
                self._conns[cid] = state
                events.append(TransportEvent("joined", cid))
            else:
                events.append(
                    TransportEvent(
                        "message", state.client_id, header, payload, wire
                    )
                )

        if closed:
            cid_opt = state.client_id
            self._drop(state)
            if cid_opt is not None:
                events.append(TransportEvent("disconnect", cid_opt))

    def wait_for_clients(
        self, client_ids: Sequence[str], timeout_s: float = 30.0
    ) -> List[TransportEvent]:
        """Block until every id has said hello (startup barrier); returns
        any non-join events observed while waiting."""
        spill: List[TransportEvent] = []
        deadline = time.monotonic() + timeout_s
        missing = set(client_ids) - set(self._conns)
        while missing:
            remaining = deadline - time.monotonic()
            if remaining <= 0.0:
                raise TimeoutError(
                    f"workers never connected: {sorted(missing)}"
                )
            for ev in self.poll(remaining):
                if ev.kind != "joined":
                    spill.append(ev)
            missing = set(client_ids) - set(self._conns)
        return spill


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReconnectPolicy:
    """Exponential backoff + jitter for worker connects (bounded retries).

    A replacement VM coming up while the server is mid-restart (or a
    transient network partition) should not kill the worker on its first
    refused connect: :func:`run_client_worker` retries up to
    ``max_attempts`` times, sleeping ``base_delay_s * multiplier**k``
    (capped at ``max_delay_s``) between attempts, each delay scaled by a
    uniform ±``jitter_frac`` factor.  The jitter is drawn from
    ``random.Random(f"{seed}:{salt}")`` — per-silo deterministic, so a
    chaos run replays the exact same backoff timeline."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter_frac: float = 0.25
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay_s <= 0.0 or self.max_delay_s <= 0.0:
            raise ValueError("backoff delays must be > 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1.0")
        if not 0.0 <= self.jitter_frac < 1.0:
            raise ValueError("jitter_frac must be in [0, 1)")

    def delays(self, salt: str = "") -> List[float]:
        """The ``max_attempts - 1`` sleep durations between attempts."""
        rng = random.Random(f"{self.seed}:{salt}")
        out: List[float] = []
        delay = self.base_delay_s
        for _ in range(self.max_attempts - 1):
            jitter = 1.0 + self.jitter_frac * (2.0 * rng.random() - 1.0)
            out.append(min(delay, self.max_delay_s) * jitter)
            delay *= self.multiplier
        return out


def _connect_with_backoff(
    address: Tuple[str, int],
    connect_timeout_s: float,
    reconnect: Optional[ReconnectPolicy],
    salt: str,
) -> Optional[socket.socket]:
    """Connect, retrying per ``reconnect``; None when every attempt fails
    (the server never learns of this worker — the driver's rejoin /
    startup timeout is what notices)."""
    policy = reconnect if reconnect is not None else ReconnectPolicy(max_attempts=1)
    delays = policy.delays(salt)
    for attempt in range(policy.max_attempts):
        try:
            sock = socket.create_connection(
                tuple(address), timeout=connect_timeout_s
            )
            sock.settimeout(None)
            return sock
        except OSError:
            if attempt < len(delays):
                time.sleep(delays[attempt])
    return None


def run_client_worker(
    client: Any,
    template_params: Any,
    address: Tuple[str, int],
    connect_timeout_s: float = 10.0,
    reconnect: Optional[ReconnectPolicy] = None,
    compression: Optional[Any] = None,
    schema: Optional[Any] = None,
) -> None:
    """Blocking worker loop: one real ``FLClient`` behind a socket.

    Speaks the §3 protocol: deserializes ``s_msg_train`` into the
    ``template_params`` structure, trains, replies ``c_msg_train`` with
    the serialized updated weights; deserializes ``s_msg_aggreg``,
    evaluates, replies ``c_msg_test`` with the serialized metrics dict.
    Any exception out of the client (or the socket) drops the connection
    — the server observes EOF, which *is* the §4.3 crash signal.

    Compute runs on a dedicated thread so the receive loop stays
    responsive: ``MSG_PING`` probes are answered immediately even while a
    slow ``train`` is running — which is exactly what lets the driver's
    liveness detector tell a *slow* silo (heartbeats flow) from a *hung*
    one (no PONG past the heartbeat timeout).  Three optional client
    hooks are honoured when present (the chaos harness's
    ``ChaosClient`` provides all three): ``on_round(round_idx, phase)``
    before each compute, ``heartbeat_ok() -> bool`` gating PONG replies,
    and ``mangle_payload(body) -> bytes`` over the serialized reply.
    ``reconnect`` bounds connect retries with backoff + jitter (a single
    attempt when None).

    ``compression`` (a :class:`~repro_torch.federated.compression
    .CompressionSpec` or codec string) switches the ``c_msg_train``
    reply to a compressed delta against the received global weights,
    with the error-feedback residual held in this worker.  The residual
    dies with the worker: a restarted or replaced VM re-encodes from a
    zero residual (slightly more compression error on its next update,
    never a correctness problem).

    ``schema`` (an :class:`~repro_torch.federated.agg_engine.UpdateSchema` or
    group mapping) switches the reply to a *structured* frame carrying
    only the schema's named parameter groups — per-group compressed
    deltas when ``compression`` is also set, raw fp32 group values
    otherwise.  The header gains ``structured``/``group_bytes``/
    ``group_dense`` so the driver's per-group byte accounting is
    measured at the sender.
    """
    sock = _connect_with_backoff(
        address, connect_timeout_s, reconnect, str(client.client_id)
    )
    if sock is None:
        return
    compressor = None
    struct_encoder = None
    if schema is not None:
        from .compression import StructuredCompressor

        # Structured replies subsume plain compression: the encoder
        # applies the codec (when any) per group, with per-group error
        # feedback scoped to this worker.
        struct_encoder = StructuredCompressor(schema, compression)
    elif compression is not None:
        from .compression import ClientCompressor, parse_compression

        spec = parse_compression(compression)
        if spec is not None:
            # Prefer a client-owned compressor (FLClient(compression=...))
            # so the error-feedback residual survives worker restarts
            # over the same client object; else the buffer is scoped to
            # this invocation (a fresh VM starts from zero residual).
            compressor = getattr(client, "compressor", None)
            if compressor is None:
                compressor = ClientCompressor(spec)
    send_lock = threading.Lock()
    jobs: "queue.Queue[Optional[Tuple[Dict[str, Any], bytes]]]" = queue.Queue()

    def _send(header: Mapping[str, Any], payload: bytes = b"") -> None:
        with send_lock:
            send_frame(sock, header, payload)

    def _mangle(body: bytes) -> bytes:
        hook = getattr(client, "mangle_payload", None)
        return bytes(hook(body)) if callable(hook) else body

    def _compute_loop() -> None:
        # A raising client IS the crash model: shut the socket down so
        # the server sees EOF, and exit quietly — the §4.3 recovery
        # story is the server's to tell, not a thread traceback's.
        try:
            while True:
                job = jobs.get()
                if job is None:
                    return
                header, payload = job
                kind = header.get("kind")
                round_idx = int(header.get("round_idx", 0))
                on_round = getattr(client, "on_round", None)
                if callable(on_round):
                    on_round(
                        round_idx, "train" if kind == MSG_S_TRAIN else "eval"
                    )
                params = deserialize_pytree(payload, template_params)
                if kind == MSG_S_TRAIN:
                    result = client.train(params)
                    header_out = {
                        "kind": MSG_C_TRAIN,
                        "round_idx": round_idx,
                        "client_id": str(client.client_id),
                        "n_samples": int(result.n_samples),
                        "train_time_s": float(result.train_time_s),
                    }
                    if struct_encoder is not None:
                        from .agg_engine import plan_for
                        from .compression import serialize_structured

                        supdate = struct_encoder.encode(
                            params, result.params, base_round=round_idx
                        )
                        header_out["structured"] = 1
                        # Dense equivalent = the FULL model's fp32 bytes:
                        # the savings being reported is "groups instead
                        # of the whole pytree", codec included.
                        header_out["dense_bytes"] = int(
                            plan_for(params).total_elems * 4
                        )
                        header_out["group_bytes"] = {
                            str(k): int(v)
                            for k, v in supdate.group_wire_bytes().items()
                        }
                        header_out["group_dense"] = {
                            str(k): int(v)
                            for k, v in supdate.group_dense_bytes().items()
                        }
                        body = serialize_structured(supdate)
                    elif compressor is not None:
                        from .compression import serialize_update

                        update = compressor.encode(params, result.params)
                        header_out["codec"] = update.codec
                        header_out["dense_bytes"] = int(update.dense_bytes)
                        body = serialize_update(update)
                    else:
                        body = serialize_pytree(result.params)
                    _send(header_out, _mangle(body))
                else:
                    ev = client.evaluate(params)
                    _send(
                        {
                            "kind": MSG_C_TEST,
                            "round_idx": round_idx,
                            "client_id": str(client.client_id),
                            "n_samples": int(ev.n_samples),
                            "eval_time_s": float(ev.eval_time_s),
                        },
                        _mangle(serialize_metrics(ev.metrics)),
                    )
        except Exception:  # noqa: BLE001 — crash-to-EOF is the §4.3 contract
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    compute = threading.Thread(
        target=_compute_loop,
        name=f"fl-compute-{client.client_id}",
        daemon=True,
    )
    compute.start()
    try:
        _send({"kind": MSG_HELLO, "client_id": str(client.client_id)})
        while True:
            frame = recv_frame(sock)
            if frame is None:
                return
            header, payload = frame
            kind = header.get("kind")
            if kind == MSG_SHUTDOWN:
                return
            if kind == MSG_PING:
                hb = getattr(client, "heartbeat_ok", None)
                if hb is None or hb():
                    _send(
                        {
                            "kind": MSG_PONG,
                            "client_id": str(client.client_id),
                            "seq": int(header.get("seq", 0)),
                        }
                    )
                continue
            if kind in (MSG_S_TRAIN, MSG_S_AGGREG):
                jobs.put((header, payload))
    except Exception:  # noqa: BLE001 — crash-to-EOF is the §4.3 contract
        pass
    finally:
        jobs.put(None)
        try:
            sock.close()
        except OSError:
            pass


@runtime_checkable
class WorkerPool(Protocol):
    """Where the driver's silos physically run (threads, processes, ...)."""

    @property
    def client_ids(self) -> Sequence[str]: ...

    def launch(self, address: Tuple[str, int]) -> None: ...

    def restart(
        self,
        client_id: str,
        address: Tuple[str, int],
        host: Optional[str] = None,
    ) -> bool: ...

    def host_of(self, client_id: str) -> Optional[str]: ...

    def shutdown(self) -> None: ...


class ThreadWorkerPool:
    """Each ``FLClient`` runs :func:`run_client_worker` on a daemon thread.

    The wire protocol, framing, crash detection, and restart path are
    byte-identical to process mode — only the isolation differs, which
    makes this the CI tier's backend (no spawn/import cost).  A crashed
    worker is restarted by spawning a fresh thread over the *same*
    client object: ``FLClient`` is stateless across rounds (weights flow
    through the server), mirroring a replacement VM restoring from the
    silo's data.

    ``restart(..., host=...)`` records which VM the replacement landed on
    (§4.4: the driver passes ``DynamicScheduler.select_instance``'s
    pick); threads have no real placement, so the host is bookkeeping —
    visible through :meth:`host_of` and the respawned thread's name —
    but it is the same restart-capacity contract process pools honour.
    ``device`` (default the card) is where the workers' weights land.
    """

    def __init__(
        self,
        clients: Sequence[Any],
        template_params: Any,
        reconnect: Optional[ReconnectPolicy] = None,
        compression: Optional[Any] = None,
        schema: Optional[Any] = None,
        device: Device = "cuda",
    ) -> None:
        self._clients: Dict[str, Any] = {
            str(c.client_id): c for c in clients
        }
        if len(self._clients) != len(clients):
            raise ValueError("duplicate client_id in worker pool")
        # The workers deserialize each s_msg_train into this structure,
        # so its device is where the silos' weights land.
        self._template = _on_device(template_params, device)
        self._reconnect = reconnect
        self._compression = compression
        self._schema = schema
        self._threads: Dict[str, threading.Thread] = {}
        self._hosts: Dict[str, str] = {}

    @property
    def client_ids(self) -> Sequence[str]:
        return list(self._clients)

    def host_of(self, client_id: str) -> Optional[str]:
        return self._hosts.get(client_id)

    def _spawn(self, client_id: str, address: Tuple[str, int]) -> None:
        host = self._hosts.get(client_id)
        name = f"fl-worker-{client_id}" + (f"@{host}" if host else "")
        thread = threading.Thread(
            target=run_client_worker,
            args=(self._clients[client_id], self._template, address),
            kwargs={
                "reconnect": self._reconnect,
                "compression": self._compression,
                "schema": self._schema,
            },
            name=name,
            daemon=True,
        )
        self._threads[client_id] = thread
        thread.start()

    def launch(self, address: Tuple[str, int]) -> None:
        for cid in self._clients:
            self._spawn(cid, address)

    def restart(
        self,
        client_id: str,
        address: Tuple[str, int],
        host: Optional[str] = None,
    ) -> bool:
        if client_id not in self._clients:
            return False
        if host is not None:
            self._hosts[client_id] = host
        self._spawn(client_id, address)
        return True

    def shutdown(self) -> None:
        # Wake compute threads parked in a chaos hang fault first —
        # otherwise the join below waits out the hang bound and the
        # orphan can outlive the interpreter (aborting at exit).
        for client in self._clients.values():
            release = getattr(client, "release", None)
            if callable(release):
                release()
        for thread in self._threads.values():
            thread.join(timeout=5.0)
        self._threads.clear()


def _on_device(tree: Any, device: Device) -> Any:
    """A tree's leaves as tensors on ``device`` (numpy leaves converted)."""
    dev = torch.device(device)
    return tree_map(lambda t: torch.as_tensor(t).to(dev), tree)


@dataclasses.dataclass(frozen=True)
class _LeafSpec:
    """A template leaf's shape and dtype: what a spawned worker needs to
    rebuild the template, without pickling the weights (bfloat16 and
    device tensors included)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    @classmethod
    def of(cls, leaf: Any) -> "_LeafSpec":
        t = torch.as_tensor(leaf)
        return cls(tuple(t.shape), t.dtype)

    def build(self, device: torch.device) -> torch.Tensor:
        # One element broadcast to the shape: deserialize_pytree reads
        # only a template leaf's shape, dtype and device.
        return torch.empty((), dtype=self.dtype, device=device).expand(self.shape)


def _process_worker_entry(
    factory: Callable[[], Any],
    template_spec: Any,
    address: Tuple[str, int],
    reconnect: Optional[ReconnectPolicy] = None,
    compression: Optional[Any] = None,
    schema: Optional[Any] = None,
    device: Device = "cuda",
) -> None:
    """Spawn entry: build the client and the template in the child, on
    ``device``, then serve.  The process ends with its worker loop, as
    the VM it stands for: without the interpreter's teardown, which
    aborts when a compute thread still holds CUDA work (a silo severed
    mid-evaluation)."""
    dev = torch.device(device)
    template = tree_map(lambda spec: spec.build(dev), template_spec)
    run_client_worker(
        factory(), template, address,
        reconnect=reconnect, compression=compression, schema=schema,
    )
    os._exit(0)


class ProcessWorkerPool:
    """Each silo is a real OS process (``multiprocessing`` spawn).

    Clients are built *in the child* from picklable factories, so each
    worker imports torch fresh and, on the card, makes its own CUDA
    context — true crash isolation at the cost of the spawn/import
    latency (seconds per worker).  The child also rebuilds the template
    on ``device`` (default the card) from the leaves' shapes and dtypes,
    so the silo's weights land there.  Like :class:`ThreadWorkerPool`, a
    §4.4 cross-host ``restart(..., host=...)`` is tracked per silo (the
    replacement process *is* the replacement VM in this model)."""

    def __init__(
        self,
        client_factories: Mapping[str, Callable[[], Any]],
        template_params: Any,
        reconnect: Optional[ReconnectPolicy] = None,
        compression: Optional[Any] = None,
        schema: Optional[Any] = None,
        device: Device = "cuda",
    ) -> None:
        self._factories: Dict[str, Callable[[], Any]] = dict(client_factories)
        # Shapes and dtypes only: the child rebuilds the template.
        self._template_spec = tree_map(_LeafSpec.of, template_params)
        self._device = str(torch.device(device))
        self._reconnect = reconnect
        # CompressionSpec is a plain frozen dataclass — pickles into the
        # spawned child with the rest of the worker args.  Schemas with
        # string/sequence selectors (or a dict of them) pickle the same
        # way; callable selectors must be module-level to spawn.
        self._compression = compression
        self._schema = schema
        self._ctx = multiprocessing.get_context("spawn")
        self._procs: Dict[str, Any] = {}
        self._hosts: Dict[str, str] = {}

    @property
    def client_ids(self) -> Sequence[str]:
        return list(self._factories)

    def host_of(self, client_id: str) -> Optional[str]:
        return self._hosts.get(client_id)

    def _spawn(self, client_id: str, address: Tuple[str, int]) -> None:
        host = self._hosts.get(client_id)
        name = f"fl-worker-{client_id}" + (f"@{host}" if host else "")
        proc = self._ctx.Process(
            target=_process_worker_entry,
            args=(
                self._factories[client_id],
                self._template_spec,
                address,
                self._reconnect,
                self._compression,
                self._schema,
                self._device,
            ),
            name=name,
            daemon=True,
        )
        self._procs[client_id] = proc
        proc.start()

    def launch(self, address: Tuple[str, int]) -> None:
        for cid in self._factories:
            self._spawn(cid, address)

    def restart(
        self,
        client_id: str,
        address: Tuple[str, int],
        host: Optional[str] = None,
    ) -> bool:
        if client_id not in self._factories:
            return False
        old = self._procs.get(client_id)
        if old is not None and old.is_alive():
            old.terminate()
            old.join(timeout=5.0)
        if host is not None:
            self._hosts[client_id] = host
        self._spawn(client_id, address)
        return True

    def shutdown(self) -> None:
        for proc in self._procs.values():
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=5.0)
        self._procs.clear()


# ---------------------------------------------------------------------------
# Recorded arrivals -> the existing fold engine
# ---------------------------------------------------------------------------

class RecordedSchedule(ArrivalSchedule):
    """Measured wall-clock arrivals replayed as an ``ArrivalSchedule``.

    This is the whole trick that makes the live transport "just another
    bus driver": the driver measures when each ``c_msg_train`` physically
    landed (and when each silo crashed / recovered), wraps the offsets in
    :class:`~repro_torch.federated.async_server.ClientArrival` records, and
    hands them to the unchanged ``AsyncRoundEngine`` — deadline
    policies, carry-over, recovery, escalation, and the event vocabulary
    all run on *recorded* rather than sampled time."""

    def __init__(self, arrivals: Mapping[str, ClientArrival]) -> None:
        self._arrivals = dict(arrivals)

    def round_arrivals(
        self, round_idx: int, client_ids: Sequence[str]
    ) -> Dict[str, ClientArrival]:
        return {cid: self._arrivals[cid] for cid in client_ids}


# ---------------------------------------------------------------------------
# Live round driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _TrainOutcome:
    """One silo's physically-observed training phase for a round."""

    arrival_s: float = math.inf
    revoke_at_s: Optional[float] = None
    attempt: int = 1
    params: Any = None
    n_samples: int = 0
    train_time_s: float = 0.0
    failed: bool = False
    crashed: bool = False    # connection dropped (§4.3 hard-fault signal)
    timed_out: bool = False  # silent past reply_timeout_s (§4.4 evidence)
    payload_bytes: int = 0
    dense_bytes: int = 0     # dense fp32 equivalent of a compressed reply
    # Structured replies: per-group wire / dense fp32 bytes as measured
    # at the sender (None on unstructured rounds).
    group_bytes: Optional[Dict[str, int]] = None
    group_dense: Optional[Dict[str, int]] = None

    def to_arrival(self, client_id: str) -> ClientArrival:
        if self.failed:
            # §4.3 suspected fault: revoked with no recorded re-arrival.
            revoke = self.revoke_at_s if self.revoke_at_s is not None else 0.0
            return ClientArrival(
                client_id, revoke, revoke_at_s=revoke, re_arrival_s=math.inf
            )
        if self.revoke_at_s is not None:
            # Crash mid-round, physically re-requested: replay the
            # measured recovery arrival.
            return ClientArrival(
                client_id,
                self.arrival_s,
                revoke_at_s=self.revoke_at_s,
                re_arrival_s=self.arrival_s,
            )
        return ClientArrival(client_id, self.arrival_s)


class LiveRoundDriver:
    """Wall-clock FL rounds over :class:`SocketTransport` workers.

    Protocol per round (§3): serialize the current weights once, send
    ``s_msg_train`` to the cohort, collect ``c_msg_train`` replies as
    they physically arrive (restarting crashed workers per §4.3), fold
    the round through the shared ``AsyncRoundEngine`` on the recorded
    offsets, then run the evaluation phase (``s_msg_aggreg`` /
    ``c_msg_test``) and report a :class:`~repro_torch.federated.server.
    RoundRecord` — the same record type, fold reports, and bus trace as
    the in-process drivers.

    Parameters mirror ``AsyncFLServer`` where they share meaning:
    ``round_deadline`` / ``carry_discount`` / ``escalate_after`` /
    ``on_revocation`` / ``max_rerequests`` / ``on_straggler``.  Live-only
    knobs: ``reply_timeout_s`` (per-phase wall bound before a silent
    silo becomes a §4.3 suspected fault; None waits indefinitely) and
    ``startup_timeout_s`` (worker hello barrier).  ``cost_model`` is
    updated with each round's *measured* message sizes via
    ``to_cost_model_sizes`` (Eq. 6 on real payloads).

    Hardening knobs (this is the live §4.3/§4.4 surface):

    * ``heartbeat_interval_s`` — PING every pending training silo at
      this cadence; a silo with no PONG for ``heartbeat_timeout_s``
      (default 3x the interval) is declared *hung* — distinguishable
      from slow, whose heartbeats keep flowing — its connection is
      severed and the ordinary §4.3 crash/re-request path takes over.
      None (the default) disables liveness probing.
    * ``scheduler`` + ``placement`` — §4.4 true replacement: every
      worker restart first asks ``scheduler.select_instance`` (the
      ``DynamicScheduler`` heuristic; the revoked VM is excluded from
      candidates) for a *different* host, records it in the mutable
      ``placement`` map, and publishes :class:`~repro_torch.core.events.
      VMReplaced`.  Without a scheduler, restarts rejoin in place.
    * ``server_ckpt`` / ``client_ckpts`` — the §4.3 checkpoint story on
      the live path, mirroring ``FLServer``: clients store each round's
      aggregate, the server checkpoints per its interval (async off-VM
      copy), both published as ``CheckpointSaved``;
      :meth:`recover_server` restores from the freshest *verified*
      source (``RecoveryCompleted`` records which one won).
    * ``chaos`` — a :class:`~repro_torch.federated.chaos.FaultPlan` whose
      driver-level kinds (``disconnect``/``revocation`` severs,
      ``corrupt_checkpoint`` sabotage-then-restore) this driver
      executes, publishing a ``FaultInjected`` marker per fault.
      Client-level kinds are executed by ``ChaosClient`` wrappers in
      the worker pool (``FaultPlan.wrap_clients``).

    ``device`` (default the card) holds the global weights; every fold
    runs there, and ``agg_time_s`` ends when the device has finished it.
    """

    def __init__(
        self,
        workers: WorkerPool,
        initial_params: Any,
        *,
        transport: Optional[SocketTransport] = None,
        round_deadline: Optional[RoundDeadline] = None,
        carry_discount: float = 0.5,
        escalate_after: int = 2,
        on_revocation: str = "rerequest",
        max_rerequests: int = 1,
        reply_timeout_s: Optional[float] = None,
        startup_timeout_s: float = 30.0,
        heartbeat_interval_s: Optional[float] = None,
        heartbeat_timeout_s: Optional[float] = None,
        scheduler: Optional[Any] = None,
        placement: Optional[MutableMapping[str, Any]] = None,
        server_ckpt: Optional[Any] = None,
        client_ckpts: Optional[Mapping[str, Any]] = None,
        chaos: Optional[FaultPlan] = None,
        agg_engine: Optional[AggregationEngine] = None,
        bus: Optional[EventBus] = None,
        on_straggler: Optional[Callable[[str, int], None]] = None,
        cost_model: Optional[Any] = None,
        measure_round_messages: bool = True,
        compression: Optional[Any] = None,
        schema: Optional[Any] = None,
        staleness_policy: Optional[Any] = None,
        device: Device = "cuda",
    ) -> None:
        if heartbeat_interval_s is not None and heartbeat_interval_s <= 0.0:
            raise ValueError("heartbeat_interval_s must be > 0 (or None)")
        if heartbeat_timeout_s is not None:
            if heartbeat_timeout_s <= 0.0:
                raise ValueError("heartbeat_timeout_s must be > 0 (or None)")
            if heartbeat_interval_s is None:
                raise ValueError(
                    "heartbeat_timeout_s requires heartbeat_interval_s"
                )
        self.workers = workers
        # The global weights live on ``device``: replies are folded there.
        self.params = _on_device(initial_params, device)
        self.bus = bus if bus is not None else EventBus()
        self.transport = transport if transport is not None else SocketTransport()
        self.reply_timeout_s = reply_timeout_s
        self.startup_timeout_s = startup_timeout_s
        self.heartbeat_interval_s = heartbeat_interval_s
        self.heartbeat_timeout_s = (
            heartbeat_timeout_s
            if heartbeat_timeout_s is not None
            else (
                3.0 * heartbeat_interval_s
                if heartbeat_interval_s is not None
                else None
            )
        )
        self.scheduler = scheduler
        self.placement = placement
        self.server_ckpt = server_ckpt
        self.client_ckpts: Dict[str, Any] = dict(client_ckpts or {})
        self.chaos = chaos
        self.on_straggler = on_straggler
        self.cost_model = cost_model
        self.measure_round_messages = measure_round_messages
        # The workers do the encoding (the pool must be built with the
        # same spec); the driver's copy drives decode + the delta-mode
        # fold + wire-vs-dense accounting in the round message logs.
        from .agg_engine import as_update_schema
        from .compression import parse_compression
        self.compression = parse_compression(compression)
        # Structured rounds: the pool's workers ship only the schema's
        # named groups; the driver folds them through the per-group
        # masked aggregator and logs per-group wire/dense bytes.
        self.schema = as_update_schema(schema)
        self._on_revocation = on_revocation
        self._max_rerequests = max_rerequests
        self._engine = AsyncRoundEngine(
            agg_engine if agg_engine is not None else AggregationEngine(),
            on_revocation=on_revocation,
            recovery_delay_s=0.0,  # recoveries are *measured*, not modeled
            max_rerequests=max_rerequests,
            deadline=round_deadline,
            carry_discount=carry_discount,
            escalate_after=escalate_after,
            bus=self.bus,
            schema=self.schema,
            staleness_policy=staleness_policy,
        )
        self.fold_reports: List[FoldReport] = []
        self.message_logs: List[RoundMessageLog] = []
        self._cohort: List[str] = [str(c) for c in workers.client_ids]
        self._awaiting_rejoin: Set[str] = set()
        self._started = False
        self._wall_t0 = time.monotonic()

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "LiveRoundDriver":
        self.start()
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.close()

    def start(self) -> None:
        """Bind the transport, launch the workers, barrier on hellos."""
        if self._started:
            return
        address = self.transport.start()
        self.workers.launch(address)
        self.transport.wait_for_clients(self._cohort, self.startup_timeout_s)
        self._wall_t0 = time.monotonic()
        self._started = True

    def close(self) -> None:
        if self._started:
            for cid in self.transport.client_ids:
                try:
                    self.transport.send(cid, {"kind": MSG_SHUTDOWN})
                except ConnectionError:
                    pass
        self.workers.shutdown()
        self.transport.close()
        self._started = False

    @property
    def trace(self) -> List[Any]:
        """The typed control-plane event trace (same vocabulary + format
        as the simulator's ``SimulationResult.trace``)."""
        return self.bus.trace

    @property
    def cohort(self) -> List[str]:
        """Silos still in the run (terminal crashes drop out)."""
        return list(self._cohort)

    def _wall(self) -> float:
        return time.monotonic() - self._wall_t0

    # -- run loop ----------------------------------------------------------
    def run(self, n_rounds: int) -> FLRunResult:
        """Drive ``n_rounds`` §3 rounds over the live workers."""
        self.start()
        t_start = time.monotonic()
        records: List[RoundRecord] = []
        for round_idx in range(1, n_rounds + 1):
            records.append(self._run_round(round_idx))
        if self.server_ckpt is not None:
            self.server_ckpt.wait_for_transfers()
        return FLRunResult(
            rounds=records,
            final_params=self.params,
            total_time_s=time.monotonic() - t_start,
        )

    # -- one round ---------------------------------------------------------
    def _run_round(self, round_idx: int) -> RoundRecord:
        self._settle_rejoins()
        # Chaos: checkpoint sabotage strikes *between* rounds (mirroring
        # FLServer's fault_hook position — marker, corruption, then the
        # §4.3 restore — all before this round's dispatch).
        restarted_from: Optional[str] = None
        if self.chaos is not None:
            for f in self.chaos.faults_for(round_idx):
                if f.kind != "corrupt_checkpoint":
                    continue
                self.bus.publish(
                    FaultInjected(
                        self._wall(), f.kind, f.task, round_idx, f.phase
                    )
                )
                corrupt_latest_checkpoint(self.server_ckpt)
                restarted_from = self.recover_server(round_idx)
        expected = [
            cid for cid in self._cohort if self.transport.is_live(cid)
        ]
        if not expected:
            raise RuntimeError("no live silos left in the cohort")
        t0 = time.monotonic()
        self.bus.publish(
            RoundDispatched(self._wall(), round_idx, len(expected))
        )
        # Chaos markers for every other kind of the round (client-side
        # kinds execute inside the workers, which have no bus — the
        # driver records the cause at the same trace position as the
        # virtual-clock ChaosSchedule).
        forced: Dict[str, str] = {}
        if self.chaos is not None:
            for f in self.chaos.faults_for(round_idx):
                if f.kind == "corrupt_checkpoint":
                    continue
                self.bus.publish(
                    FaultInjected(
                        self._wall(), f.kind, f.task, round_idx, f.phase
                    )
                )
                if f.phase == "train" and f.kind in DRIVER_KINDS:
                    forced[f.task] = f.kind

        # Training phase: s_msg_train out, c_msg_train back (measured).
        s_train_payload = serialize_pytree(self.params)
        dispatched: List[str] = []
        for cid in expected:
            try:
                self.transport.send(
                    cid,
                    {"kind": MSG_S_TRAIN, "round_idx": round_idx},
                    s_train_payload,
                )
                dispatched.append(cid)
            except ConnectionError:
                self._drop_from_cohort(cid)
        if not dispatched:
            raise RuntimeError("every silo disconnected at dispatch")

        outcomes = self._collect_train(
            round_idx, dispatched, t0, s_train_payload, forced
        )

        t_agg = time.monotonic()
        results = [
            ClientResult(cid, o.params, o.n_samples, o.train_time_s)
            for cid, o in outcomes.items()
        ]
        schedule = RecordedSchedule(
            {cid: o.to_arrival(cid) for cid, o in outcomes.items()}
        )
        fold = self._engine.fold_round(
            round_idx, results, schedule,
            base_params=(
                self.params
                if (self.compression is not None or self.schema is not None)
                else None
            ),
        )
        self.fold_reports.append(fold)
        self.params = fold.params
        synchronize(tree_device(self.params))
        agg_time = time.monotonic() - t_agg
        train_time = time.monotonic() - t0

        # §4.4: consecutive reply timeouts escalate like deadline misses
        # (the engine handles carried-over silos itself; timeouts are
        # excluded from the fold, so the driver advances the tracker).
        # An on-time delivery clears the silo's streak — the engine only
        # does that when a RoundDeadline is configured — and so does a
        # crash: replacing the worker destroys the slow-silo evidence
        # (the StragglerTracker contract), so a recovery that overran
        # the reply window must not count as a strike.
        for cid, o in outcomes.items():
            if o.timed_out:
                streak = self._engine.stragglers.record_miss(cid)
                if streak is not None:
                    self.bus.publish(
                        StragglerEscalated(
                            o.revoke_at_s or 0.0,
                            cid,
                            round_idx=round_idx,
                            consecutive_misses=streak,
                        )
                    )
                    if self.on_straggler is not None:
                        self.on_straggler(cid, round_idx)
            elif o.crashed or (
                not o.failed and cid not in fold.carried_over
            ):
                # Carried-over silos keep the miss the engine recorded;
                # everyone else's evidence resets.
                self._engine.stragglers.clear(cid)
        for cid in fold.escalations:
            if self.on_straggler is not None:
                self.on_straggler(cid, round_idx)

        # Evaluation phase: s_msg_aggreg out, c_msg_test back.
        t1 = time.monotonic()
        s_aggreg_payload = serialize_pytree(self.params)
        eval_targets: List[str] = []
        for cid in self._cohort:
            if not self.transport.is_live(cid):
                continue
            try:
                self.transport.send(
                    cid,
                    {"kind": MSG_S_AGGREG, "round_idx": round_idx},
                    s_aggreg_payload,
                )
                eval_targets.append(cid)
            except ConnectionError:
                self._drop_from_cohort(cid)
        # Chaos: driver-level eval-phase faults sever now — the silo
        # skips this round's metrics only; the stray-disconnect path
        # restarts it (cross-host when a scheduler is attached) so it
        # rejoins for the next round.
        if self.chaos is not None:
            for f in self.chaos.faults_for(round_idx, phase="eval"):
                if (
                    f.kind in DRIVER_KINDS
                    and f.task in eval_targets
                    and self.transport.disconnect(f.task)
                ):
                    eval_targets.remove(f.task)
                    self._handle_stray_disconnect(f.task)
        metrics_by_cid, eval_n, c_test_bytes = self._collect_eval(
            round_idx, eval_targets, t1
        )
        if metrics_by_cid:
            order = sorted(metrics_by_cid)
            metrics = aggregate_metrics(
                [metrics_by_cid[cid] for cid in order],
                [max(eval_n.get(cid, 1), 1) for cid in order],
            )
        else:
            metrics = {}
        eval_time = time.monotonic() - t1

        # Checkpointing (§4.3), mirroring FLServer: every surviving silo
        # stores the aggregate each round, the server per its interval,
        # each location's overhead published separately.
        t2 = time.monotonic()
        saved_client = False
        for cid in self._cohort:
            mgr = self.client_ckpts.get(cid)
            if mgr is not None:
                mgr.save(round_idx, self.params)
                saved_client = True
        client_ckpt_time = time.monotonic() - t2
        t3 = time.monotonic()
        saved_server = (
            self.server_ckpt is not None
            and self.server_ckpt.should_checkpoint(round_idx)
        )
        if saved_server and self.server_ckpt is not None:
            self.server_ckpt.save(round_idx, self.params)
        server_ckpt_time = time.monotonic() - t3
        ckpt_time = client_ckpt_time + server_ckpt_time
        if saved_client:
            self.bus.publish(
                CheckpointSaved(self._wall(), round_idx, "client_local",
                                client_ckpt_time)
            )
        if saved_server:
            self.bus.publish(
                CheckpointSaved(self._wall(), round_idx, "server_remote",
                                server_ckpt_time)
            )

        log: Optional[RoundMessageLog] = None
        if self.measure_round_messages:
            c_train_bytes = max(
                (o.payload_bytes for o in outcomes.values()
                 if o.payload_bytes > 0),
                default=len(s_train_payload),
            )
            # With compression, payload_bytes is the measured compressed
            # frame (what crossed the socket) — the wire truth Eq. 6
            # needs; the workers' reported dense-equivalent size rides
            # along so the log can state the achieved ratio.
            dense_train = max(
                (o.dense_bytes for o in outcomes.values()
                 if o.dense_bytes > 0),
                default=0,
            )
            # Per-group byte maps (structured rounds): merged over the
            # round's replies by max, like the scalar fields — the log
            # records a representative (worst-case) per-silo frame.
            group_wire: Optional[Dict[str, int]] = None
            group_dense: Optional[Dict[str, int]] = None
            for o in outcomes.values():
                if o.group_bytes:
                    group_wire = group_wire or {}
                    for k, v in o.group_bytes.items():
                        group_wire[k] = max(group_wire.get(k, 0), int(v))
                if o.group_dense:
                    group_dense = group_dense or {}
                    for k, v in o.group_dense.items():
                        group_dense[k] = max(group_dense.get(k, 0), int(v))
            if self.schema is not None:
                codec = ("structured" if self.compression is None
                         else f"structured:{self.compression.codec}")
            elif self.compression is not None:
                codec = self.compression.codec
            else:
                codec = "none"
            log = RoundMessageLog(
                s_msg_train_bytes=len(s_train_payload),
                c_msg_train_bytes=c_train_bytes,
                s_msg_aggreg_bytes=len(s_aggreg_payload),
                c_msg_test_bytes=max(
                    c_test_bytes, default=len(serialize_metrics(metrics))
                ),
                codec=codec,
                c_msg_train_dense_bytes=dense_train or None,
                group_wire_bytes=group_wire,
                group_dense_bytes=group_dense,
            )
            self.message_logs.append(log)
            if self.cost_model is not None:
                # Eq. 6 on measured payloads: the scheduler's comm-cost
                # terms track what this run actually moved on the wire.
                self.cost_model.update_message_sizes(to_cost_model_sizes(log))

        return RoundRecord(
            round_idx=round_idx,
            train_time_s=train_time,
            eval_time_s=eval_time,
            checkpoint_time_s=ckpt_time,
            metrics=metrics,
            message_log=log,
            restarted_from=restarted_from,
            agg_time_s=agg_time,
            fold_times_s=dict(fold.fold_times),
            round_span_s=fold.round_span_s,
            idle_s=fold.idle_s,
            deadline_s=fold.deadline_s,
            carried_over=list(fold.carried_over),
            carried_in=list(fold.carried_in),
        )

    # -- §4.3 / §4.4 recovery ----------------------------------------------
    def _restart_worker(self, client_id: str) -> bool:
        """Respawn a dead silo's worker — on a *different* host when a
        scheduler is attached (§4.4 true replacement).

        ``DynamicScheduler.select_instance`` excludes the revoked VM
        from its candidate set, so the pick is a genuine move; the
        mutable ``placement`` map is updated and ``VMReplaced`` is
        published only once the pool actually spawned the replacement.
        Without a scheduler (or for silos outside the placement map) the
        restart rejoins in place, exactly as before."""
        decision: Optional[Any] = None
        old_vm = ""
        if (
            self.scheduler is not None
            and self.placement is not None
            and client_id in self.placement
        ):
            old_vm = str(self.placement[client_id].vm_id)
            decision = self.scheduler.select_instance(
                client_id, dict(self.placement), old_vm, now_s=self._wall()
            )
            if decision is not None and not getattr(decision, "new_vm", None):
                decision = None
        host = None if decision is None else str(decision.new_vm)
        ok = self.workers.restart(client_id, self.transport.address, host=host)
        if ok and decision is not None and self.placement is not None:
            market = str(getattr(decision, "market", "on_demand"))
            self.placement[client_id] = Assignment(
                str(decision.new_vm), market
            )
            self.bus.publish(
                VMReplaced(
                    self._wall(),
                    client_id,
                    old_vm,
                    str(decision.new_vm),
                    market,
                    "revocation",
                )
            )
        return ok

    def recover_server(self, resume_round: int) -> str:
        """Restore the aggregate from the freshest *verified* checkpoint
        (§4.3), mirroring ``FLServer._recover_server``: corrupt or
        truncated files are skipped by the managers' verified-restore
        path, so sabotage falls back to the newest intact source.
        Publishes ``RecoveryCompleted`` recording which source won."""
        if self.server_ckpt is None and not self.client_ckpts:
            source, info = "none", None
        else:
            source, info = resolve_freshest(self.server_ckpt, self.client_ckpts)
        if source == "none" or info is None:
            self.bus.publish(
                RecoveryCompleted(self._wall(), "s", resume_round, 0.0, "none")
            )
            return "none"
        if source == "server":
            assert self.server_ckpt is not None
            _, self.params = self.server_ckpt.restore(self.params, info)
        else:
            cid = source.split(":", 1)[1]
            _, self.params = self.client_ckpts[cid].restore(self.params)
        restored = (
            "server_remote" if source == "server"
            else f"client_local:{source.split(':', 1)[1]}"
        )
        self.bus.publish(
            RecoveryCompleted(self._wall(), "s", resume_round, 0.0, restored)
        )
        return source

    # -- collection loops --------------------------------------------------
    def _drop_from_cohort(self, client_id: str) -> None:
        if client_id in self._cohort:
            self._cohort.remove(client_id)

    def _handle_stray_disconnect(self, client_id: str) -> None:
        """A silo crashed *outside* its training reply (after delivering,
        or during the evaluation phase).  The round is unaffected — the
        already-delivered rule — but §4.3 still owes the silo a
        replacement: restart the worker so it rejoins for the next
        round (it merely skips this round's metrics); only when no
        replacement can be spawned does the silo leave the run."""
        if self._on_revocation == "rerequest" and self._restart_worker(
            client_id
        ):
            self._awaiting_rejoin.add(client_id)
            return
        self._drop_from_cohort(client_id)

    def _settle_rejoins(self) -> None:
        """Barrier on restarted workers' hellos before dispatching a
        round, so a silo replaced between rounds (eval-phase crash) is
        back in the cohort and not skipped by a hello/dispatch race.
        A replacement that never connects within the startup window is
        dropped from the run."""
        self._awaiting_rejoin = {
            cid for cid in self._awaiting_rejoin
            if cid in self._cohort and not self.transport.is_live(cid)
        }
        deadline = time.monotonic() + self.startup_timeout_s
        while self._awaiting_rejoin and time.monotonic() < deadline:
            self.transport.poll(0.05)
            self._awaiting_rejoin = {
                cid for cid in self._awaiting_rejoin
                if not self.transport.is_live(cid)
            }
        for cid in sorted(self._awaiting_rejoin):
            self._drop_from_cohort(cid)
        self._awaiting_rejoin.clear()

    def _collect_train(
        self,
        round_idx: int,
        expected: Sequence[str],
        t0: float,
        s_train_payload: bytes,
        forced: Optional[Mapping[str, str]] = None,
    ) -> Dict[str, _TrainOutcome]:
        outcomes: Dict[str, _TrainOutcome] = {
            cid: _TrainOutcome() for cid in expected
        }
        pending: Set[str] = set(expected)
        rejoining: Set[str] = set()
        rejoin_by: Dict[str, float] = {}  # restart -> hello deadline (wall)
        deadline = (
            None if self.reply_timeout_s is None
            else t0 + self.reply_timeout_s
        )
        # Liveness probing state (heartbeat_interval_s only).
        hb = self.heartbeat_interval_s
        hb_timeout = self.heartbeat_timeout_s
        last_seen: Dict[str, float] = {cid: t0 for cid in expected}
        next_ping = None if hb is None else t0 + hb
        ping_seq = 0

        def crash(cid: str, now_off: float) -> None:
            """The §4.3 hard-fault path: re-request via a (possibly
            cross-host) worker restart, or exclude + drop."""
            o = outcomes[cid]
            o.crashed = True
            if o.revoke_at_s is None:
                o.revoke_at_s = now_off
            if (
                self._on_revocation == "rerequest"
                and o.attempt <= self._max_rerequests
                and self._restart_worker(cid)
            ):
                rejoining.add(cid)
                rejoin_by[cid] = time.monotonic() + self.startup_timeout_s
            else:
                o.failed = True
                pending.discard(cid)
                self._drop_from_cohort(cid)

        # Chaos: driver-level train-phase faults sever right after
        # dispatch — the worker dies on EOF (a mid-compute silo fails on
        # its reply send), and recovery runs the ordinary crash path.
        for cid in sorted(forced or ()):
            if cid in pending and self.transport.disconnect(cid):
                crash(cid, time.monotonic() - t0)

        while pending:
            now = time.monotonic()
            waits: List[float] = []
            if deadline is not None:
                waits.append(deadline - now)
            if rejoin_by:
                # A restarted worker that never says hello (child died
                # before connecting, connect refused) must not hang an
                # unbounded round: bound the wait on its rejoin too.
                waits.append(min(rejoin_by.values()) - now)
            if next_ping is not None:
                waits.append(next_ping - now)
                if hb_timeout is not None:
                    expiries = [
                        last_seen[c] + hb_timeout - now
                        for c in pending
                        if c not in rejoining
                    ]
                    if expiries:
                        waits.append(min(expiries))
            timeout = max(0.0, min(waits)) if waits else None
            events = self.transport.poll(timeout)
            now = time.monotonic()
            now_off = now - t0
            for cid in [c for c, t in rejoin_by.items() if now >= t]:
                # Replacement never came up: §4.3 exclusion, and the
                # silo leaves the run (its worker is gone for good).
                del rejoin_by[cid]
                rejoining.discard(cid)
                outcomes[cid].failed = True
                pending.discard(cid)
                self._drop_from_cohort(cid)
            if next_ping is not None and hb is not None and now >= next_ping:
                next_ping = now + hb
                ping_seq += 1
                for cid in sorted(pending - rejoining):
                    if not self.transport.is_live(cid):
                        continue
                    try:
                        self.transport.send(
                            cid, {"kind": MSG_PING, "seq": ping_seq}
                        )
                    except ConnectionError:
                        crash(cid, now_off)
                if hb_timeout is not None:
                    # No PONG within the timeout = *hung*, not slow (a
                    # slow silo's receive loop still answers probes):
                    # sever and run the §4.3 crash path.  A silo with
                    # traffic in this very poll batch is alive — skip it.
                    seen_now = {ev.client_id for ev in events}
                    for cid in sorted(pending - rejoining - seen_now):
                        if now - last_seen.get(cid, t0) > hb_timeout:
                            self.transport.disconnect(cid)
                            crash(cid, now_off)
            if not events:
                if deadline is not None and now >= deadline:
                    # Reply timeout.  A silent-but-alive silo is a §4.4
                    # straggler suspect: it stays in the cohort, its
                    # stale reply is discarded by round tag, and its
                    # miss streak advances.  A silo whose *recovery* is
                    # what overran the window crashed — the replacement
                    # destroyed the slow-silo evidence, so it is only
                    # excluded (§4.3), never counted as a strike.
                    for cid in sorted(pending):
                        o = outcomes[cid]
                        o.failed = True
                        o.timed_out = not o.crashed
                        if o.revoke_at_s is None:
                            o.revoke_at_s = now_off
                    pending.clear()
                continue
            for ev in events:
                cid = ev.client_id
                if cid in last_seen:
                    last_seen[cid] = now
                if ev.kind == "disconnect":
                    if cid not in pending:
                        self._handle_stray_disconnect(cid)
                        continue
                    crash(cid, now_off)
                elif ev.kind == "joined":
                    if cid in rejoining:
                        rejoining.discard(cid)
                        rejoin_by.pop(cid, None)
                        o = outcomes[cid]
                        o.attempt += 1
                        try:
                            self.transport.send(
                                cid,
                                {"kind": MSG_S_TRAIN, "round_idx": round_idx},
                                s_train_payload,
                            )
                        except ConnectionError:
                            o.failed = True
                            pending.discard(cid)
                            self._drop_from_cohort(cid)
                elif (
                    ev.kind == "message"
                    and ev.header.get("kind") == MSG_C_TRAIN
                ):
                    if (
                        int(ev.header.get("round_idx", -1)) != round_idx
                        or cid not in pending
                    ):
                        continue  # stale reply from a previous round
                    o = outcomes[cid]
                    try:
                        # Compressed replies carry their codec in the
                        # header; a frame corrupted in either encoding
                        # raises the same DeserializationError, so the
                        # §4.3 re-request recovery below is shared.
                        if ev.header.get("structured"):
                            from .compression import deserialize_structured

                            params = deserialize_structured(ev.payload)
                        elif ev.header.get("codec") is not None:
                            from .compression import deserialize_update

                            params = deserialize_update(ev.payload)
                        else:
                            params = deserialize_pytree(ev.payload, self.params)
                    except DeserializationError:
                        # Corrupt frame: the reply arrived but is
                        # unusable — a §4.3 suspected fault.  The worker
                        # is alive, so re-request over the *same*
                        # connection (attempt bump mirrors the crash
                        # path); past the budget the silo is excluded
                        # from the round but stays in the cohort.
                        if o.revoke_at_s is None:
                            o.revoke_at_s = now_off
                        if (
                            self._on_revocation == "rerequest"
                            and o.attempt <= self._max_rerequests
                            and self.transport.is_live(cid)
                        ):
                            o.attempt += 1
                            try:
                                self.transport.send(
                                    cid,
                                    {
                                        "kind": MSG_S_TRAIN,
                                        "round_idx": round_idx,
                                    },
                                    s_train_payload,
                                )
                            except ConnectionError:
                                crash(cid, now_off)
                        else:
                            o.failed = True
                            pending.discard(cid)
                        continue
                    o.arrival_s = now_off
                    o.params = params
                    o.n_samples = int(ev.header.get("n_samples", 0))
                    o.train_time_s = float(ev.header.get("train_time_s", 0.0))
                    o.payload_bytes = len(ev.payload)
                    o.dense_bytes = int(ev.header.get("dense_bytes", 0))
                    gb = ev.header.get("group_bytes")
                    if isinstance(gb, Mapping):
                        o.group_bytes = {str(k): int(v) for k, v in gb.items()}
                    gd = ev.header.get("group_dense")
                    if isinstance(gd, Mapping):
                        o.group_dense = {str(k): int(v) for k, v in gd.items()}
                    pending.discard(cid)
        return outcomes

    def _collect_eval(
        self,
        round_idx: int,
        expected: Sequence[str],
        t1: float,
    ) -> Tuple[Dict[str, Dict[str, float]], Dict[str, int], List[int]]:
        metrics_by_cid: Dict[str, Dict[str, float]] = {}
        eval_n: Dict[str, int] = {}
        sizes: List[int] = []
        pending: Set[str] = set(expected)
        deadline = (
            None if self.reply_timeout_s is None
            else t1 + self.reply_timeout_s
        )
        while pending:
            timeout: Optional[float] = None
            if deadline is not None:
                timeout = max(0.0, deadline - time.monotonic())
            events = self.transport.poll(timeout)
            if not events:
                if deadline is not None and time.monotonic() >= deadline:
                    break  # slow evaluators are skipped, not faulted
                continue
            for ev in events:
                cid = ev.client_id
                if ev.kind == "disconnect":
                    # Evaluation-phase crash: this round just skips the
                    # silo's metrics; §4.3 still restarts the worker so
                    # it rejoins for the next round.
                    pending.discard(cid)
                    self._handle_stray_disconnect(cid)
                elif (
                    ev.kind == "message"
                    and ev.header.get("kind") == MSG_C_TEST
                ):
                    if (
                        int(ev.header.get("round_idx", -1)) != round_idx
                        or cid not in pending
                    ):
                        continue
                    raw = unpackb(ev.payload)
                    metrics_by_cid[cid] = {
                        str(k): float(v) for k, v in dict(raw).items()
                    }
                    eval_n[cid] = int(ev.header.get("n_samples", 0))
                    sizes.append(len(ev.payload))
                    pending.discard(cid)
        return metrics_by_cid, eval_n, sizes
