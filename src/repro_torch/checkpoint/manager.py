"""Checkpoint manager implementing the paper's §4.3 semantics on real
directories — the port of ``repro/checkpoint/manager.py``, writing and
reading the same files:

  * server side — checkpoint every X rounds to "local disk" (the VM), then
    asynchronously copy to "stable storage" (another location: a storage
    service or an extra VM). The copy is a background thread; a checkpoint
    is only *durable* (restorable after the server VM dies) once the copy
    finishes.  The tree is serialized to host bytes on the calling thread
    before anything is written, so the thread only copies a file and
    never touches a device tensor.
  * client side — the aggregated weights received each round are written to
    the client VM's local disk only.
  * restore — freshest-wins: compare the newest durable server checkpoint's
    round with the newest client round; server reads its own if newer,
    otherwise waits for a client to upload (paper: "the FL server ... waits
    for any client to send its weights").

Integrity: revocations and crashes happen *during* writes, and storage
bit-rots — a checkpoint you cannot trust is worse than none, because the
§4.3 restore silently resumes from garbage.  Every checkpoint file is
therefore framed ``FLCK1\\n`` + CRC32 + payload length + payload, written
tmp-file-first with ``fsync`` before the atomic rename (a torn write can
only ever leave the *old* file in place), and every read verifies the
checksum.  ``latest``/``latest_durable``/``resolve_freshest`` consider
only the newest *verified* checkpoint; ``restore`` walks older candidates
(with a warning per skipped file) until one decodes, so a corrupted or
truncated newest file degrades the restore point instead of crashing it.
Pre-integrity (headerless) files are still read, with corruption caught
at deserialize time instead of the checksum.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import struct
import threading
import warnings
import zlib
from typing import Any, List, Mapping, Optional, Tuple

from .serializer import DeserializationError, deserialize_pytree, serialize_pytree

_CKPT_RE = re.compile(r"^round_(\d+)\.ckpt$")

# On-disk frame: magic, then (crc32, payload length) big-endian, then the
# serialized pytree.  The magic doubles as a format-version tag.
_MAGIC = b"FLCK1\n"
_HEADER = struct.Struct(">IQ")


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint file failed integrity verification (bad magic size,
    truncated payload, CRC32 mismatch, or an empty file)."""


@dataclasses.dataclass
class CheckpointInfo:
    round_idx: int
    path: str
    durable: bool  # True once it lives in stable storage


# ---------------------------------------------------------------------------
# Verified file I/O
# ---------------------------------------------------------------------------

def _fsync_dir(d: str) -> None:
    """Best-effort directory fsync so the rename itself is durable."""
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_verified(path: str, blob: bytes) -> None:
    """Atomically publish ``blob`` at ``path`` with an integrity header.

    tmp-write -> flush -> fsync -> rename -> dir fsync: a crash at any
    point leaves either the previous file or the complete new one — never
    a torn frame under the final name."""
    tmp = path + ".tmp"
    header = _HEADER.pack(zlib.crc32(blob) & 0xFFFFFFFF, len(blob))
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(header)
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def _read_verified(path: str) -> bytes:
    """Read a checkpoint file, verifying its integrity frame.

    Returns the payload blob.  Headerless (pre-integrity) files pass
    through unverified — their corruption surfaces as a
    :class:`~repro_torch.checkpoint.serializer.DeserializationError` at decode
    time, which restore paths treat identically."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_MAGIC):
        if not data:
            raise CheckpointCorruptionError(f"{path}: empty checkpoint file")
        return data  # legacy headerless blob
    off = len(_MAGIC)
    if len(data) < off + _HEADER.size:
        raise CheckpointCorruptionError(f"{path}: truncated header")
    crc, length = _HEADER.unpack(data[off:off + _HEADER.size])
    blob = data[off + _HEADER.size:]
    if len(blob) != length:
        raise CheckpointCorruptionError(
            f"{path}: payload truncated ({len(blob)} of {length} bytes)"
        )
    if zlib.crc32(blob) & 0xFFFFFFFF != crc:
        raise CheckpointCorruptionError(f"{path}: CRC32 mismatch")
    return blob


def _quick_verify(path: str) -> bool:
    """Integrity check without deserializing (used to pick the newest
    *verified* checkpoint).  Headerless legacy files can only be checked
    for non-emptiness here."""
    try:
        _read_verified(path)
    except (CheckpointCorruptionError, OSError):
        return False
    return True


def _restore_newest(
    d: str, like: Any, what: str, prefer: Optional[CheckpointInfo] = None
) -> Tuple[int, Any]:
    """Decode the newest readable checkpoint in ``d``, walking past
    corrupt/unreadable candidates with a warning each (§4.3: degrade the
    restore point, never crash the restore)."""
    candidates = sorted(_list_ckpts(d), key=lambda c: -c.round_idx)
    if prefer is not None:
        candidates = [prefer] + [
            c for c in candidates if c.path != prefer.path
        ]
    for ck in candidates:
        try:
            blob = _read_verified(ck.path)
            return ck.round_idx, deserialize_pytree(blob, like)
        except (CheckpointCorruptionError, DeserializationError, OSError) as exc:
            warnings.warn(
                f"skipping unreadable checkpoint {ck.path}: {exc}",
                RuntimeWarning,
                stacklevel=2,
            )
    raise FileNotFoundError(f"no {what} checkpoint")


class ServerCheckpointManager:
    """Server-side checkpointing with async off-VM transfer."""

    def __init__(
        self,
        local_dir: str,
        remote_dir: str,
        interval_rounds: int = 10,
        keep_last: int = 3,
    ) -> None:
        self.local_dir = local_dir
        self.remote_dir = remote_dir
        self.interval_rounds = interval_rounds
        self.keep_last = keep_last
        os.makedirs(local_dir, exist_ok=True)
        os.makedirs(remote_dir, exist_ok=True)
        self._pending: List[threading.Thread] = []

    def should_checkpoint(self, round_idx: int) -> bool:
        return self.interval_rounds > 0 and round_idx % self.interval_rounds == 0

    def save(self, round_idx: int, state: Any, blocking_transfer: bool = False) -> str:
        """Synchronous local write, asynchronous remote copy."""
        blob = serialize_pytree(state)
        fname = f"round_{round_idx}.ckpt"
        local_path = os.path.join(self.local_dir, fname)
        _write_verified(local_path, blob)

        def _transfer() -> None:
            remote_tmp = os.path.join(self.remote_dir, fname + ".tmp")
            remote_path = os.path.join(self.remote_dir, fname)
            with open(local_path, "rb") as src, open(remote_tmp, "wb") as dst:
                shutil.copyfileobj(src, dst)
                dst.flush()
                os.fsync(dst.fileno())
            os.replace(remote_tmp, remote_path)
            _fsync_dir(self.remote_dir)

        if blocking_transfer:
            _transfer()
        else:
            t = threading.Thread(target=_transfer, daemon=True)
            t.start()
            self._pending.append(t)
        self._gc(self.local_dir)
        return local_path

    def wait_for_transfers(self, timeout: Optional[float] = None) -> None:
        for t in self._pending:
            t.join(timeout)
        self._pending = [t for t in self._pending if t.is_alive()]

    def latest_durable(self) -> Optional[CheckpointInfo]:
        return _latest_in(self.remote_dir, durable=True)

    def latest_local(self) -> Optional[CheckpointInfo]:
        return _latest_in(self.local_dir, durable=False)

    def restore(self, like: Any, info: Optional[CheckpointInfo] = None) -> Tuple[int, Any]:
        """Restore from stable storage, preferring ``info`` when given;
        corrupt or truncated files are skipped (with a warning) in favour
        of the next-newest verified checkpoint."""
        return _restore_newest(
            self.remote_dir, like, "durable server", prefer=info
        )

    def _gc(self, d: str) -> None:
        cks = sorted(_list_ckpts(d), key=lambda c: c.round_idx)
        for c in cks[: -self.keep_last]:
            try:
                os.remove(c.path)
            except OSError:
                pass


class ClientCheckpointManager:
    """Client-side: store every round's aggregated weights on local disk."""

    def __init__(self, local_dir: str, keep_last: int = 2) -> None:
        self.local_dir = local_dir
        self.keep_last = keep_last
        os.makedirs(local_dir, exist_ok=True)

    def save(self, round_idx: int, weights: Any) -> str:
        blob = serialize_pytree(weights)
        path = os.path.join(self.local_dir, f"round_{round_idx}.ckpt")
        _write_verified(path, blob)
        cks = sorted(_list_ckpts(self.local_dir), key=lambda c: c.round_idx)
        for c in cks[: -self.keep_last]:
            try:
                os.remove(c.path)
            except OSError:
                pass
        return path

    def latest(self) -> Optional[CheckpointInfo]:
        return _latest_in(self.local_dir, durable=False)

    def restore(self, like: Any) -> Tuple[int, Any]:
        """Restore the newest verified local checkpoint, skipping past
        corrupt files with a warning."""
        return _restore_newest(self.local_dir, like, "client")


def resolve_freshest(
    server: Optional[ServerCheckpointManager],
    clients: Mapping[str, ClientCheckpointManager],
    exclude_client: Optional[str] = None,
) -> Tuple[str, Optional[CheckpointInfo]]:
    """Paper §4.3 restore rule. Returns ("server"|"client:<id>"|"none", info).

    `server` may be None (no server-side checkpointing configured): the
    clients' local copies of the aggregated weights still restore the run.
    Every candidate is the source's newest *verified* checkpoint, so a
    sabotaged server file automatically yields to an intact (possibly
    client-side) one.
    """
    s = server.latest_durable() if server is not None else None
    best_cid, best_c = None, None
    for cid, mgr in clients.items():
        if cid == exclude_client:
            continue
        c = mgr.latest()
        if c is not None and (best_c is None or c.round_idx > best_c.round_idx):
            best_cid, best_c = cid, c
    if s is not None and (best_c is None or s.round_idx >= best_c.round_idx):
        return "server", s
    if best_c is not None:
        return f"client:{best_cid}", best_c
    return "none", None


def _list_ckpts(d: str) -> List[CheckpointInfo]:
    """Enumerate round checkpoints, skipping obviously unreadable entries
    (zero-byte truncation stubs, stat failures) with a warning — the
    opaque-deserializer-error-on-empty-file regression."""
    out: List[CheckpointInfo] = []
    if not os.path.isdir(d):
        return out
    for fname in os.listdir(d):
        m = _CKPT_RE.match(fname)
        if not m:
            continue
        path = os.path.join(d, fname)
        try:
            size = os.path.getsize(path)
        except OSError as exc:
            warnings.warn(
                f"skipping unreadable checkpoint {path}: {exc}",
                RuntimeWarning,
                stacklevel=2,
            )
            continue
        if size == 0:
            warnings.warn(
                f"skipping empty checkpoint file {path}",
                RuntimeWarning,
                stacklevel=2,
            )
            continue
        out.append(CheckpointInfo(int(m.group(1)), path, False))
    return out


def _latest_in(d: str, durable: bool) -> Optional[CheckpointInfo]:
    """The newest *verified* checkpoint in ``d`` (corrupt newer files are
    passed over so the §4.3 freshest-wins comparison never proposes a
    restore point that cannot actually be read)."""
    for ck in sorted(_list_ckpts(d), key=lambda c: -c.round_idx):
        if _quick_verify(ck.path):
            ck.durable = durable
            return ck
    return None
