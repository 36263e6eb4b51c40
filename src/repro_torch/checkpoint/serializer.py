"""Tree <-> bytes serialization, byte for byte the reference's v1 blob.

A blob is the msgpack map ``{"version": 1, "entries": [...]}`` with one
entry per leaf, in ``jax.tree`` leaf order: ``{"path", "dtype", "shape",
"data"}``, where ``data`` is the leaf's raw C-order bytes.  It is what
``repro/checkpoint/serializer.py`` writes, so a blob written by either
package restores in the other.  The port packs it with its own msgpack
subset (:mod:`._msgpack`) and names bfloat16 leaves ``"bfloat16"``, their
bytes the raw 16-bit patterns, without ``ml_dtypes``.

Device tensors are copied to host bytes here, on the calling thread.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..utils.tree import path_str, tree_flatten_with_path, tree_leaves, tree_unflatten
from ._msgpack import packb, unpackb

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


def _leaf_record(leaf: Any) -> Tuple[str, Tuple[int, ...], bytes]:
    """(dtype name, shape, raw bytes) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = _EXTENSION_NAMES.get(t.dtype)
        t = t.to("cpu").contiguous()
        if name is not None:
            bits = _EXTENSION_DTYPES[name][0]
            raw = t.view(torch.int16 if bits.itemsize == 2 else torch.int8).numpy()
            return name, tuple(t.shape), raw.tobytes()
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr.dtype.name, tuple(arr.shape), arr.tobytes()


def serialize_pytree(tree: Any) -> bytes:
    """Pack a tree of tensors (or arrays) into one self-describing blob."""
    entries = []
    for path, leaf in tree_flatten_with_path(tree)[0]:
        dtype, shape, data = _leaf_record(leaf)
        entries.append(
            {"path": path_str(path), "dtype": dtype, "shape": list(shape), "data": data}
        )
    return packb({"version": 1, "entries": entries})


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
