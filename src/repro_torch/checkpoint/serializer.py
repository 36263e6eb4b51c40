"""Tree <-> bytes serialization, byte for byte the reference's v1 blob.

A blob is the msgpack map ``{"version": 1, "entries": [...]}`` with one
entry per leaf, in ``jax.tree`` leaf order: ``{"path", "dtype", "shape",
"data"}``, where ``data`` is the leaf's raw C-order bytes.  It is what
``repro/checkpoint/serializer.py`` writes, so a blob written by either
package restores in the other.  The port packs it with its own msgpack
subset (:mod:`._msgpack`) and names bfloat16 leaves ``"bfloat16"``, their
bytes the raw 16-bit patterns, without ``ml_dtypes``.

Device tensors are copied to host bytes here, on the calling thread: the
blob is laid out once, and each CUDA leaf's bytes reach their place in it
through two small pinned buffers the thread keeps, the card filling one
while the host empties the other.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..utils import spans
from ..utils.tree import path_str, tree_flatten_with_path, tree_leaves, tree_unflatten
from ._msgpack import Hole, pack_segments, unpackb

# Extension dtypes numpy cannot name: carried as raw integer bits of the
# same width, viewed as the torch dtype.
_EXTENSION_DTYPES: Dict[str, Tuple[np.dtype, torch.dtype]] = {
    "bfloat16": (np.dtype(np.int16), torch.bfloat16),
    "float8_e4m3fn": (np.dtype(np.int8), torch.float8_e4m3fn),
    "float8_e5m2": (np.dtype(np.int8), torch.float8_e5m2),
}
_EXTENSION_NAMES = {tdt: name for name, (_, tdt) in _EXTENSION_DTYPES.items()}


class DeserializationError(ValueError):
    """The blob itself is unreadable — truncated, bit-flipped, or not a
    checkpoint at all.  Distinct from a *valid* blob that mismatches the
    ``like`` template (missing leaf -> KeyError, shape drift ->
    ValueError): those mean the wrong checkpoint for this model, this
    means corruption — §4.3 restore paths catch it and fall back."""


def _dtype_name(dtype: torch.dtype) -> str:
    """The blob's name of a torch dtype: numpy's, or the extension name."""
    name = _EXTENSION_NAMES.get(dtype)
    return name if name is not None else torch.empty(0, dtype=dtype).numpy().dtype.name


# Bytes of a staging chunk: a CUDA leaf goes to the host through two
# such pinned buffers in turn, so a thread pins 64 MiB however large the
# tree (torch's host allocator keeps them pinned once freed).
_CHUNK = 1 << 25
_staging = threading.local()


def _staging_buffers() -> List[torch.Tensor]:
    """The calling thread's two pinned chunks, made at its first call and
    kept for its later ones; threads that serialize at once (the live
    transport's thread silos) each have their own."""
    bufs = getattr(_staging, "bufs", None)
    if bufs is None:
        bufs = _staging.bufs = [torch.empty(_CHUNK, dtype=torch.uint8, pin_memory=True)
                                for _ in range(2)]
    return bufs


def _stage(dst: torch.Tensor, leaves: List[Tuple[int, torch.Tensor]]) -> int:
    """Write each CUDA leaf's raw C-order bytes into ``dst`` at its offset,
    and return how many bytes that was.

    The bytes are copied, without waiting, on the leaf's device's current
    stream into one of the thread's pinned chunks; while the card fills
    one, the host copies the other out to ``dst``, after one wait on an
    event for it.  A non-contiguous leaf is made contiguous on its card
    first, one leaf at a time."""
    bufs = _staging_buffers()
    pieces: List[List[Tuple[int, int, int]]] = [[], []]  # (chunk offset, dst offset, n)
    devices: List[set] = [set(), set()]
    done: List[List[Any]] = [[], []]

    def seal(k: int) -> None:
        done[k] = [torch.cuda.current_stream(d).record_event() for d in devices[k]]
        devices[k] = set()

    def drain(k: int) -> None:
        for event in done[k]:
            event.synchronize()
        for at, out, n in pieces[k]:
            dst[out:out + n].copy_(bufs[k][at:at + n])
        pieces[k], done[k] = [], []

    k = used = total = 0
    for out, leaf in leaves:
        flat = leaf.contiguous().reshape(-1).view(torch.uint8)
        start = 0
        while start < flat.numel():
            n = min(flat.numel() - start, _CHUNK - used)
            bufs[k][used:used + n].copy_(flat[start:start + n], non_blocking=True)
            pieces[k].append((used, out + start, n))
            devices[k].add(flat.device)
            used, start, total = used + n, start + n, total + n
            if used == _CHUNK:
                seal(k)
                k, used = 1 - k, 0
                drain(k)
    seal(k)
    drain(1 - k)
    drain(k)
    return total


# A bytes object made with no contents may be written through its pointer
# until it is handed out: the C-API's way to build one in place.
_bytes_new = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_void_p, ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))
_bytes_data = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object)(
    ("PyBytes_AsString", ctypes.pythonapi))


def serialize_pytree(tree: Any) -> bytes:
    """Pack a tree of tensors (or arrays) into one self-describing blob.

    The entries' msgpack headers are packed around a :class:`Hole` for
    each leaf's data, and the blob is made empty at its full length and
    filled in one pass: the headers and the host leaves' bytes where they
    lie, the CUDA leaves' through the pinned chunks (:func:`_stage`).
    Torch's intra-op threads do the large copies, so they take the fresh
    pages' first-touch faults side by side.  Counts the staged bytes into
    ``fl.bytes.staged`` while spans are on (0 for a tree with no CUDA
    leaf)."""
    entries, leaves = [], []
    for path, leaf in tree_flatten_with_path(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            dtype, nbytes = _dtype_name(leaf.dtype), leaf.numel() * leaf.element_size()
        else:
            leaf = np.asarray(leaf)
            dtype, nbytes = leaf.dtype.name, leaf.nbytes
        leaves.append((leaf, nbytes))
        entries.append(
            {"path": path_str(path), "dtype": dtype, "shape": list(leaf.shape),
             "data": Hole(nbytes)}
        )
    heads = pack_segments({"version": 1, "entries": entries})
    blob = _bytes_new(None, sum(map(len, heads)) + sum(n for _, n in leaves))
    raw = (ctypes.c_char * len(blob)).from_address(_bytes_data(blob))
    dst, dst_np = torch.frombuffer(raw, dtype=torch.uint8), np.frombuffer(raw, np.uint8)
    on_card: List[Tuple[int, torch.Tensor]] = []
    offset = 0
    for head, (leaf, n) in zip(heads, leaves + [(None, 0)]):
        dst_np[offset:offset + len(head)] = np.frombuffer(head, np.uint8)
        offset += len(head)
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            on_card.append((offset, leaf))
        elif isinstance(leaf, torch.Tensor):
            dst[offset:offset + n].copy_(leaf.contiguous().reshape(-1).view(torch.uint8))
        elif leaf is not None:
            dst_np[offset:offset + n] = np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)
        offset += n
    if on_card:
        spans.count("fl.bytes.staged", _stage(dst, on_card))
    return blob


def _tensor_from_entry(e: Dict[str, Any]) -> torch.Tensor:
    name = e["dtype"]
    shape = [int(s) for s in e["shape"]]
    if name in _EXTENSION_DTYPES:
        bits, tdt = _EXTENSION_DTYPES[name]
        arr = np.frombuffer(e["data"], dtype=bits).reshape(shape)
        return torch.from_numpy(arr.copy()).view(tdt)
    arr = np.frombuffer(e["data"], dtype=np.dtype(name)).reshape(shape)
    return torch.from_numpy(arr.copy())


def deserialize_pytree(blob: Any, like: Any) -> Any:
    """Restore into the structure of ``like`` (paths must match).

    Each restored leaf takes the dtype of ``like``'s leaf and, where that
    leaf is a tensor, its device; other leaves come back as CPU tensors.
    Raises :class:`DeserializationError` when the blob is malformed
    (truncated msgpack, garbled entries, buffer/shape size mismatch) —
    template mismatches against ``like`` keep their KeyError/ValueError.
    """
    try:
        payload = unpackb(blob)
        by_path: Dict[str, torch.Tensor] = {}
        for e in payload["entries"]:
            by_path[e["path"]] = _tensor_from_entry(e)
    except Exception as exc:  # noqa: BLE001 — any parse failure is corruption
        raise DeserializationError(f"malformed checkpoint blob: {exc}") from exc

    pairs, treedef = tree_flatten_with_path(like)
    new_leaves = []
    for path, leaf in pairs:
        key = path_str(path)
        if key not in by_path:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = by_path[key]
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(np.shape(leaf))
        if tuple(t.shape) != want:
            raise ValueError(
                f"shape mismatch for {key!r}: checkpoint {tuple(t.shape)} vs model {want}"
            )
        if isinstance(leaf, torch.Tensor):
            t = t.to(device=leaf.device, dtype=leaf.dtype)
        elif hasattr(leaf, "dtype") and leaf.dtype.name not in _EXTENSION_DTYPES:
            t = t.to(torch.from_numpy(np.zeros(0, leaf.dtype)).dtype)
        new_leaves.append(t)
    return tree_unflatten(treedef, new_leaves)


def pytree_num_bytes(tree: Any) -> int:
    """Total bytes of a tree's leaves."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += np.asarray(leaf).nbytes
    return total
