"""Client-side update compression for the c_msg_train wire path.

The port of ``repro/federated/compression.py``.
Real inter-cloud WAN links (the paper's AWS<->GCP deployment, §5) give a
few percent of loopback throughput, so wire bytes dominate the Eq.-7
communication term.  Each client's *delta* against the round's global
weights is compressed before it is serialized into a transport frame:

  ``int8``  — symmetric per-block quantization, one fp32 scale per
              ``QBLOCK`` = 8192 elements (the ``dequant_fold`` kernel's
              scale block); ~3.98x smaller than fp32.
  ``fp16``  — half-precision cast; 2x smaller, near-lossless.
  ``topk``  — magnitude top-k sparsification (k = ``k_frac`` of the
              elements); int32 indices + fp16 values, ~6.7x smaller at
              the default ``k_frac=0.1``.

Deltas because the weighted average ``g + sum(w_i * d_i) / W`` is
exactly the plain FedAvg of the raw parameters (the base cancels), and
because deltas are the small-magnitude signal quantization and top-k
keep well.  Per-client error-feedback residuals (:class:`ClientCompressor`)
carry whatever a codec dropped into the next round's delta.

The codecs run in torch on the update's device (on the card in a
compressed round), with the reference's numpy arithmetic: the fp32
division is not reordered, ``torch.round`` rounds half to even as
``np.rint`` does, and all-zero blocks get scale 0 and codes 0.  So the
int8 and fp16 frames are byte-identical to the reference's.  Top-k keeps
the k largest magnitudes; where several elements tie at the k-th
magnitude, neither ``np.argpartition`` nor ``torch.topk`` fixes which of
them it keeps.  Frames go through the port's own msgpack subset
(:mod:`..checkpoint._msgpack`).

A :class:`CompressedUpdate` holds torch tensors; the server folds its
payload straight into the fp32 accumulator through the ``dequant_fold``
kernel and never makes a dense fp32 copy.

Structured updates (:class:`StructuredUpdate`, :class:`StructuredCompressor`)
carry only named parameter groups of the model (an
:class:`~repro_torch.federated.agg_engine.UpdateSchema`): each group
ships its raw fp32 values or, with a codec, its compressed delta with an
error-feedback residual of its own.  Their frames are the reference's
byte for byte too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..checkpoint._msgpack import packb, unpackb
from ..checkpoint.serializer import DeserializationError
from ..utils import spans

# One quantization block per dequant_fold scale block
# (kernels/fedavg_reduce.BLOCK): the (B,) scale vector on the wire feeds
# the kernel directly.
QBLOCK: int = 8 * 128 * 8

CODECS: Tuple[str, ...] = ("int8", "fp16", "topk")

_WIRE_VERSION = 1

_BYTES = (bytes, bytearray, memoryview)


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Validated compression configuration (builder knob payload).

    ``codec`` is one of :data:`CODECS`; ``k_frac`` only applies to
    ``topk`` (fraction of elements kept, in (0, 1]); ``error_feedback``
    enables the per-client residual buffer (recommended — required for
    top-k convergence).
    """

    codec: str
    k_frac: float = 0.1
    error_feedback: bool = True

    def __post_init__(self) -> None:
        if self.codec not in CODECS:
            raise ValueError(
                f"unknown compression codec {self.codec!r}; expected one of {CODECS}"
            )
        if not (0.0 < self.k_frac <= 1.0):
            raise ValueError(f"topk k_frac must be in (0, 1], got {self.k_frac}")


def parse_compression(
    spec: Union[None, str, CompressionSpec],
) -> Optional[CompressionSpec]:
    """Coerce a user-facing compression knob into a :class:`CompressionSpec`.

    Accepts ``None`` (off), an existing spec, or a string: ``"int8"``,
    ``"fp16"``, ``"topk"``, or ``"topk:0.05"`` (explicit kept fraction).
    Raises ``ValueError`` on anything else, so bad knobs fail before any
    round runs.
    """
    if spec is None:
        return None
    if isinstance(spec, CompressionSpec):
        return spec
    if not isinstance(spec, str):
        raise ValueError(
            f"compression must be None, a codec string, or a CompressionSpec; "
            f"got {type(spec).__name__}"
        )
    name, _, arg = spec.partition(":")
    name = name.strip().lower()
    if arg:
        if name != "topk":
            raise ValueError(f"only the topk codec takes a parameter, got {spec!r}")
        try:
            k_frac = float(arg)
        except ValueError as exc:
            raise ValueError(f"bad topk fraction in {spec!r}") from exc
        return CompressionSpec(codec="topk", k_frac=k_frac)
    return CompressionSpec(codec=name)


def topk_count(total_elems: int, k_frac: float) -> int:
    """Number of elements a top-k codec keeps (at least 1)."""
    return max(1, int(round(total_elems * k_frac)))


@dataclasses.dataclass(frozen=True)
class CompressedUpdate:
    """One client's compressed delta, as carried on the wire.

    ``data`` holds the quantized payload (int8 codes, fp16 values, or the
    fp16 top-k values), ``total_elems`` long for int8 and fp16; ``scales``
    the per-:data:`QBLOCK` fp32 dequantization scales (int8 only);
    ``indices`` the sorted int32 element indices (topk only).  All three
    are torch tensors on one device.  ``total_elems`` is the dense length
    the update folds into.

    ``base_round`` tags which round's global weights the delta was taken
    against, so the aggregator can refuse a fold against any other
    round's weights; ``None`` means untagged.
    """

    codec: str
    total_elems: int
    data: torch.Tensor
    scales: Optional[torch.Tensor] = None
    indices: Optional[torch.Tensor] = None
    base_round: Optional[int] = None

    @property
    def wire_bytes(self) -> int:
        """Serialized frame size (what actually crosses the transport).
        This builds the whole frame on the host, as the reference does."""
        with spans.span("fl.fold.frame"):
            return len(serialize_update(self))

    @property
    def dense_bytes(self) -> int:
        """Dense fp32 equivalent (what an uncompressed frame would carry)."""
        return self.total_elems * 4


def _num_blocks(total_elems: int) -> int:
    return -(-total_elems // QBLOCK)


def compress(
    flat: Any,
    spec: CompressionSpec,
    base_round: Optional[int] = None,
) -> CompressedUpdate:
    """Compress a dense fp32 vector (a flattened delta) with ``spec``.

    ``flat`` is a tensor or a numpy array; the codec runs on its device
    and is deterministic, so the same delta gives the same frame on the
    card and on the CPU.  ``base_round`` tags the update with the round
    whose global weights the delta was taken against.
    """
    vec = torch.as_tensor(flat).reshape(-1).to(torch.float32).contiguous()
    n = int(vec.numel())
    if n == 0:
        raise ValueError("cannot compress an empty update")

    if spec.codec == "fp16":
        return CompressedUpdate(codec="fp16", total_elems=n, data=vec.to(torch.float16),
                                base_round=base_round)

    if spec.codec == "topk":
        k = topk_count(n, spec.k_frac)
        if k >= n:
            idx = torch.arange(n, dtype=torch.int64, device=vec.device)
        else:
            idx = torch.topk(vec.abs(), k, sorted=False).indices.sort().values
        return CompressedUpdate(
            codec="topk",
            total_elems=n,
            data=vec[idx].to(torch.float16),
            indices=idx.to(torch.int32),
            base_round=base_round,
        )

    # int8: symmetric per-QBLOCK scales, scale = absmax / 127.
    nb = _num_blocks(n)
    padded = vec.new_zeros(nb * QBLOCK)
    padded[:n] = vec
    blocks = padded.view(nb, QBLOCK)
    scales = blocks.abs().amax(dim=1) / 127.0
    safe = torch.where(scales > 0.0, scales, torch.ones_like(scales))
    q = torch.round(blocks / safe[:, None]).clamp_(-127, 127).to(torch.int8)
    q[scales == 0.0] = 0
    return CompressedUpdate(codec="int8", total_elems=n, data=q.view(-1)[:n], scales=scales,
                            base_round=base_round)


def decompress(update: CompressedUpdate) -> torch.Tensor:
    """Dense fp32 reconstruction on the payload's device (the server-side
    fold uses the fused kernel instead and never calls this per round)."""
    n = update.total_elems
    data = update.data
    if update.codec == "fp16":
        return data.to(torch.float32)
    if update.codec == "topk":
        assert update.indices is not None
        out = torch.zeros(n, dtype=torch.float32, device=data.device)
        out[update.indices.to(torch.int64)] = data.to(torch.float32)
        return out
    assert update.scales is not None
    nb = _num_blocks(n)
    padded = torch.zeros(nb * QBLOCK, dtype=torch.float32, device=data.device)
    padded[:n] = data.to(torch.float32)
    deq = padded.view(nb, QBLOCK) * update.scales.to(torch.float32)[:, None]
    return deq.view(-1)[:n]


def materialize_update(base: Any, update: CompressedUpdate) -> Any:
    """Dense tree equivalent of ``base + decompress(update)``.

    A compressed update is a delta against one specific round's global
    weights; anything that outlives that round — above all a
    :class:`~repro_torch.federated.agg_engine.CarryEntry` parked for a
    later round's fold — must be pinned to dense parameters while the
    origin base is still on hand.
    """
    from .agg_engine import plan_for

    plan = plan_for(base)
    if update.total_elems != plan.total_elems:
        raise ValueError(
            f"compressed update has {update.total_elems} elements; "
            f"the base has {plan.total_elems}"
        )
    g = plan.flatten(base)
    return plan.unflatten(g + decompress(update).to(g.device))


# ---------------------------------------------------------------------------
# Wire form: one msgpack blob per update, embedded as a frame payload
# ---------------------------------------------------------------------------

def _tensor_bytes(t: torch.Tensor) -> bytes:
    return t.detach().to("cpu").contiguous().numpy().tobytes()


def _update_obj(update: CompressedUpdate) -> Dict[str, Any]:
    """The msgpack-able dict form of one compressed update, keys in the
    reference's order."""
    obj: Dict[str, Any] = {
        "v": _WIRE_VERSION,
        "codec": update.codec,
        "n": int(update.total_elems),
        "data": _tensor_bytes(update.data),
    }
    if update.scales is not None:
        obj["scales"] = _tensor_bytes(update.scales.to(torch.float32))
    if update.indices is not None:
        obj["idx"] = _tensor_bytes(update.indices.to(torch.int32))
    if update.base_round is not None:
        obj["br"] = int(update.base_round)
    return obj


def serialize_update(update: CompressedUpdate) -> bytes:
    """msgpack wire form of a compressed update (a c_msg_train payload):
    the bytes ``msgpack.packb(obj, use_bin_type=True)`` gives."""
    return packb(_update_obj(update))


def deserialize_update(payload: bytes) -> CompressedUpdate:
    """Decode a compressed c_msg_train payload into CPU tensors.

    Raises :class:`~repro_torch.checkpoint.serializer.DeserializationError`
    on any malformed, truncated, or internally inconsistent frame — the
    typed error the dense path raises, so §4.3 corrupt-frame re-request
    recovery applies unchanged to compressed frames.
    """
    try:
        obj = unpackb(payload)
    except Exception as exc:  # noqa: BLE001 — any parse failure is corruption
        raise DeserializationError(f"malformed compressed update frame: {exc}") from exc
    if not isinstance(obj, dict):
        raise DeserializationError("compressed update frame is not a map")
    return _decode_update_obj(obj)


def _from_bytes(raw: Any, dtype: np.dtype) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(raw, dtype=dtype).copy())


def _decode_update_obj(obj: Dict[str, Any]) -> CompressedUpdate:
    """Validate + decode one update obj (see :func:`_update_obj`)."""
    if obj.get("v") != _WIRE_VERSION:
        raise DeserializationError(f"unsupported compressed update version {obj.get('v')!r}")
    codec = obj.get("codec")
    if codec not in CODECS:
        raise DeserializationError(f"unknown codec {codec!r} in update frame")
    n = obj.get("n")
    if not isinstance(n, int) or n <= 0:
        raise DeserializationError(f"bad element count {n!r} in update frame")
    raw = obj.get("data")
    if not isinstance(raw, _BYTES):
        raise DeserializationError("compressed update frame has no data field")
    base_round = obj.get("br")
    if base_round is not None and not isinstance(base_round, int):
        raise DeserializationError(f"bad base round tag {base_round!r} in update frame")

    if codec == "fp16":
        if len(raw) != 2 * n:
            raise DeserializationError(f"fp16 payload length {len(raw)} != 2 * {n}")
        return CompressedUpdate(codec="fp16", total_elems=n,
                                data=_from_bytes(raw, np.dtype(np.float16)),
                                base_round=base_round)

    if codec == "topk":
        rawi = obj.get("idx")
        if not isinstance(rawi, _BYTES):
            raise DeserializationError("topk update frame has no index field")
        if len(rawi) % 4 or len(raw) != 2 * (len(rawi) // 4):
            raise DeserializationError(
                f"topk payload lengths inconsistent: {len(raw)}B values, "
                f"{len(rawi)}B indices"
            )
        idx = np.frombuffer(rawi, dtype=np.int32)
        if idx.size == 0 or idx.size > n:
            raise DeserializationError(f"topk index count {idx.size} out of range")
        if int(idx[0]) < 0 or int(idx[-1]) >= n or np.any(np.diff(idx) <= 0):
            raise DeserializationError("topk indices not sorted within range")
        return CompressedUpdate(codec="topk", total_elems=n,
                                data=_from_bytes(raw, np.dtype(np.float16)),
                                indices=torch.from_numpy(idx.copy()),
                                base_round=base_round)

    # int8
    raws = obj.get("scales")
    if not isinstance(raws, _BYTES):
        raise DeserializationError("int8 update frame has no scales field")
    if len(raw) != n:
        raise DeserializationError(f"int8 payload length {len(raw)} != {n}")
    if len(raws) != 4 * _num_blocks(n):
        raise DeserializationError(
            f"int8 scale length {len(raws)} != 4 * {_num_blocks(n)} blocks"
        )
    return CompressedUpdate(codec="int8", total_elems=n,
                            data=_from_bytes(raw, np.dtype(np.int8)),
                            scales=_from_bytes(raws, np.dtype(np.float32)),
                            base_round=base_round)


def compressed_wire_bytes(total_elems: int, spec: CompressionSpec) -> int:
    """Serialized c_msg_train size for a model of ``total_elems`` weights.

    Compressed frame sizes are data-independent given the element count
    (fixed-width codes plus msgpack framing), so message accounting can
    report exact wire bytes without compressing real data: this
    serializes an all-zero frame of the codec's lengths.
    """
    if total_elems <= 0:
        raise ValueError("cannot compress an empty update")
    if spec.codec == "topk":
        k = min(topk_count(total_elems, spec.k_frac), total_elems)
        update = CompressedUpdate("topk", total_elems, torch.zeros(k, dtype=torch.float16),
                                  indices=torch.zeros(k, dtype=torch.int32))
    elif spec.codec == "fp16":
        update = CompressedUpdate("fp16", total_elems,
                                  torch.zeros(total_elems, dtype=torch.float16))
    else:
        update = CompressedUpdate("int8", total_elems, torch.zeros(total_elems, dtype=torch.int8),
                                  scales=torch.zeros(_num_blocks(total_elems)))
    return len(serialize_update(update))


# ---------------------------------------------------------------------------
# Client-side encoder with error feedback
# ---------------------------------------------------------------------------

class ClientCompressor:
    """Per-client delta encoder with an error-feedback residual.

    Each round the client compresses ``delta = local - global`` *plus*
    whatever earlier rounds' codecs dropped (``residual``), then stores
    the new quantization error for the next round:

        e_t   = delta_t + residual_{t-1}
        u_t   = compress(e_t)
        residual_t = e_t - decompress(u_t)

    The residual lives with the client, on the update's device; a
    restarted or replaced worker starts with a zero residual.
    """

    def __init__(self, spec: CompressionSpec) -> None:
        self.spec = spec
        self._residual: Optional[torch.Tensor] = None

    def encode(
        self,
        global_params: Any,
        local_params: Any,
        base_round: Optional[int] = None,
    ) -> CompressedUpdate:
        """Compress this round's update against the round's global weights,
        tagged with ``base_round``."""
        from .agg_engine import plan_for

        plan = plan_for(global_params)
        delta = plan.flatten(local_params) - plan.flatten(global_params)
        if self.spec.error_feedback and self._residual is not None:
            delta = delta + self._residual
        update = compress(delta, self.spec, base_round=base_round)
        if self.spec.error_feedback:
            self._residual = delta - decompress(update)
        return update

    def reset(self) -> None:
        self._residual = None


# ---------------------------------------------------------------------------
# Structured updates: named parameter groups on the wire
# ---------------------------------------------------------------------------

# A group's wire payload is either raw fp32 *values* (a 1-D tensor: the
# group's current parameters, when the group needs no codec) or a
# CompressedUpdate *delta* against the group's slice of the round base.
GroupPayload = Union[torch.Tensor, CompressedUpdate]


@dataclasses.dataclass(frozen=True)
class StructuredUpdate:
    """One client's structured ``c_msg_train``: named per-group payloads.

    Only the groups the client trained ride the wire: a federated-LoRA
    client ships just its ``adapters`` group.  ``schema_signature`` pins
    the exact (model structure x group partition) the payloads were
    encoded under; the structured aggregator refuses a fold under any
    other schema.  ``base_round`` tags the round whose global weights
    compressed group deltas were taken against (raw-value groups are
    base-independent)."""

    groups: Tuple[Tuple[str, GroupPayload], ...]
    schema_signature: str
    base_round: Optional[int] = None

    @property
    def wire_bytes(self) -> int:
        """Serialized frame size (what actually crosses the transport).
        This builds the whole frame on the host, as the reference does."""
        with spans.span("fl.fold.frame"):
            return len(serialize_structured(self))

    @property
    def dense_bytes(self) -> int:
        """Dense fp32 equivalent of the *shipped* groups only."""
        return sum(self.group_dense_bytes().values())

    def group_wire_bytes(self) -> Dict[str, int]:
        """Per-group serialized payload sizes (RoundMessageLog accounting)."""
        return {name: len(packb(_group_obj(payload))) for name, payload in self.groups}

    def group_dense_bytes(self) -> Dict[str, int]:
        """Per-group dense fp32 equivalents."""
        return {
            name: (payload.dense_bytes if isinstance(payload, CompressedUpdate)
                   else int(torch.as_tensor(payload).numel()) * 4)
            for name, payload in self.groups
        }

    def group_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.groups)


def _group_obj(payload: GroupPayload) -> Dict[str, Any]:
    if isinstance(payload, CompressedUpdate):
        return _update_obj(payload)
    vec = torch.as_tensor(payload).reshape(-1).to(torch.float32)
    return {"raw": _tensor_bytes(vec), "n": int(vec.numel())}


def serialize_structured(update: StructuredUpdate) -> bytes:
    """msgpack wire form of a structured update (a c_msg_train payload)."""
    obj: Dict[str, Any] = {
        "v": _WIRE_VERSION,
        "structured": 1,
        "sig": update.schema_signature,
        "groups": [[name, _group_obj(p)] for name, p in update.groups],
    }
    if update.base_round is not None:
        obj["br"] = int(update.base_round)
    return packb(obj)


def deserialize_structured(payload: bytes) -> StructuredUpdate:
    """Decode a structured c_msg_train payload into CPU tensors (typed
    errors, like :func:`deserialize_update`, so §4.3 re-request recovery
    applies)."""
    try:
        obj = unpackb(payload)
    except Exception as exc:  # noqa: BLE001 — any parse failure is corruption
        raise DeserializationError(f"malformed structured update frame: {exc}") from exc
    if not isinstance(obj, dict) or obj.get("structured") != 1:
        raise DeserializationError("not a structured update frame")
    if obj.get("v") != _WIRE_VERSION:
        raise DeserializationError(f"unsupported structured update version {obj.get('v')!r}")
    sig = obj.get("sig")
    if not isinstance(sig, str) or not sig:
        raise DeserializationError("structured update frame has no schema tag")
    base_round = obj.get("br")
    if base_round is not None and not isinstance(base_round, int):
        raise DeserializationError(f"bad base round tag {base_round!r} in structured frame")
    raw_groups = obj.get("groups")
    if not isinstance(raw_groups, list) or not raw_groups:
        raise DeserializationError("structured update frame has no groups")
    groups: List[Tuple[str, GroupPayload]] = []
    for entry in raw_groups:
        if (not isinstance(entry, (list, tuple)) or len(entry) != 2
                or not isinstance(entry[0], str) or not isinstance(entry[1], dict)):
            raise DeserializationError("structured update group entry is not [name, payload]")
        name, sub = entry
        if "raw" in sub:
            raw = sub.get("raw")
            n = sub.get("n")
            if not isinstance(raw, _BYTES):
                raise DeserializationError(f"group {name!r} raw payload is not bytes")
            if not isinstance(n, int) or n <= 0 or len(raw) != 4 * n:
                raise DeserializationError(
                    f"group {name!r} raw payload length {len(raw)} != 4 * {n!r}")
            groups.append((name, _from_bytes(raw, np.dtype(np.float32))))
        else:
            groups.append((name, _decode_update_obj(sub)))
    return StructuredUpdate(groups=tuple(groups), schema_signature=sig, base_round=base_round)


def materialize_structured(base: Any, update: StructuredUpdate, schema: Any) -> Dict[str, torch.Tensor]:
    """Base-independent raw-values form of a structured update, for
    carry-over parking: compressed group deltas only mean something
    against their origin round's base, so a parked update is pinned to
    per-group raw fp32 *values* (on the base's device) while that base is
    still on hand.  The structured aggregator folds the returned
    ``{group: vector}`` mapping in any later round."""
    resolved = schema if hasattr(schema, "plan") else schema.resolve(base)
    if update.schema_signature != resolved.signature:
        raise ValueError(
            f"structured update was encoded under schema "
            f"{update.schema_signature}, not {resolved.signature}"
        )
    out: Dict[str, torch.Tensor] = {}
    for name, payload in update.groups:
        gp = resolved.group(name)
        if isinstance(payload, CompressedUpdate):
            if payload.total_elems != gp.total_elems:
                raise ValueError(
                    f"group {name!r} update has {payload.total_elems} "
                    f"elements; the group has {gp.total_elems}"
                )
            g = gp.flatten(base)
            out[name] = g + decompress(payload).to(g.device)
        else:
            out[name] = torch.as_tensor(payload).to(torch.float32)
    return out


class StructuredCompressor:
    """Per-client structured encoder: one payload per schema group.

    Without a codec each group ships its raw fp32 *values* (already a huge
    win when the schema selects a small group like LoRA adapters); with a
    :class:`CompressionSpec` each group's *delta* against the round base
    is compressed on its own, with its own error-feedback residual (a
    group the client skips a round keeps its residual).  The schema is
    resolved against the first round's global weights and re-resolved
    only when the structure changes."""

    def __init__(self, schema: Any, spec: Union[None, str, CompressionSpec] = None) -> None:
        from .agg_engine import as_update_schema

        self.schema = as_update_schema(schema)
        if self.schema is None:
            raise ValueError("StructuredCompressor needs a schema")
        self.spec = parse_compression(spec)
        self._resolved: Any = None
        self._residuals: Dict[str, torch.Tensor] = {}

    def _resolve(self, params: Any) -> Any:
        from .agg_engine import plan_for

        plan = plan_for(params)
        if self._resolved is None or self._resolved.plan.signature != plan.signature:
            assert self.schema is not None
            self._resolved = self.schema.resolve(params)
        return self._resolved

    def encode(self, global_params: Any, local_params: Any,
               base_round: Optional[int] = None) -> StructuredUpdate:
        """Encode every schema group of this round's update."""
        resolved = self._resolve(global_params)
        groups: List[Tuple[str, GroupPayload]] = []
        for name, gp in resolved.groups:
            p = gp.flatten(local_params)
            if self.spec is None:
                groups.append((name, p))
                continue
            delta = p - gp.flatten(global_params).to(p.device)
            residual = self._residuals.get(name)
            if self.spec.error_feedback and residual is not None:
                delta = delta + residual
            update = compress(delta, self.spec, base_round=base_round)
            if self.spec.error_feedback:
                self._residuals[name] = delta - decompress(update)
            groups.append((name, update))
        return StructuredUpdate(groups=tuple(groups), schema_signature=resolved.signature,
                                base_round=base_round if self.spec is not None else None)

    def reset(self) -> None:
        self._residuals = {}
