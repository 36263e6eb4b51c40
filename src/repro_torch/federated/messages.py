"""FL message accounting (paper §3).

The port of ``repro/federated/messages.py``.  Four message kinds per
round: s_msg_train (server -> clients, initial weights), c_msg_train
(client -> server, updated weights), s_msg_aggreg (server -> clients,
aggregated weights), c_msg_test (client -> server, ML metrics).  Byte
sizes are measured from the *actual serialized payloads* — the same v1
blob, msgpack metrics frame and compressed update frame the reference
sends, so the counts agree byte for byte.

With wire compression the ``c_msg_train`` leg carries a quantized or
sparsified delta: ``c_msg_train_bytes`` is then the *wire* size, and
``c_msg_train_dense_bytes`` keeps the dense fp32 equivalent so reports
can state the achieved compression ratio.  With a ``schema`` the leg is
a structured frame and the log carries per-group wire and dense bytes.
``to_cost_model_sizes`` hands a measured log to the scheduler's cost
model (Eq. 6), as the live transport does after every round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

from ..checkpoint._msgpack import packb
from ..checkpoint.serializer import pytree_num_bytes, serialize_pytree
from ..core.application_model import MessageSizes
from .compression import (
    CompressionSpec,
    StructuredCompressor,
    compressed_wire_bytes,
    parse_compression,
    serialize_structured,
)


@dataclasses.dataclass(frozen=True)
class RoundMessageLog:
    s_msg_train_bytes: int
    c_msg_train_bytes: int
    s_msg_aggreg_bytes: int
    c_msg_test_bytes: int
    # Wire-compression accounting: the codec the c_msg_train leg used
    # ("none" = raw fp32 tree frames) and, when compressed, the dense
    # fp32 size the same update would have cost uncompressed.
    codec: str = "none"
    c_msg_train_dense_bytes: Optional[int] = None
    # Structured-update accounting: per-group wire and dense fp32 bytes
    # of the c_msg_train leg when clients ship named parameter groups
    # (None = unstructured round).
    group_wire_bytes: Optional[Dict[str, int]] = None
    group_dense_bytes: Optional[Dict[str, int]] = None

    def total_bytes(self, n_clients: int) -> int:
        """Bytes on the wire for a full round with n_clients."""
        return n_clients * (
            self.s_msg_train_bytes
            + self.c_msg_train_bytes
            + self.s_msg_aggreg_bytes
            + self.c_msg_test_bytes
        )

    @property
    def compression_ratio(self) -> Optional[float]:
        """dense / wire for the c_msg_train leg (None when uncompressed)."""
        if self.c_msg_train_dense_bytes is None or self.c_msg_train_bytes <= 0:
            return None
        return self.c_msg_train_dense_bytes / self.c_msg_train_bytes


def serialize_metrics(metrics: Dict[str, float]) -> bytes:
    """The wire form of a ``c_msg_test`` payload (msgpack, like weights)."""
    return packb({str(k): float(v) for k, v in metrics.items()})


def measure_messages(
    params: Any,
    metrics_example: Dict[str, float],
    compression: Union[None, str, CompressionSpec] = None,
    schema: Any = None,
) -> RoundMessageLog:
    """Measure real serialized sizes for one round's message set.

    With ``compression`` the ``c_msg_train`` leg is the compressed frame
    size (exact: compressed frames are fixed-width given the element
    count), and the dense fp32 equivalent is reported alongside; the
    server -> client legs always ship dense weights.

    With a ``schema`` (an :class:`~repro_torch.federated.agg_engine.UpdateSchema`
    or a group mapping) the ``c_msg_train`` leg is a structured frame:
    only the named groups ride the wire, per-group byte maps fill
    ``group_wire_bytes``/``group_dense_bytes``, and the dense equivalent
    stays the FULL model's fp32 size."""
    weight_bytes = len(serialize_pytree(params))
    c_train_bytes = weight_bytes
    codec = "none"
    dense: Optional[int] = None
    group_wire: Optional[Dict[str, int]] = None
    group_dense: Optional[Dict[str, int]] = None
    spec = parse_compression(compression)
    if schema is not None:
        from .agg_engine import plan_for

        comp = StructuredCompressor(schema, spec)
        update = comp.encode(params, params, base_round=0)
        c_train_bytes = len(serialize_structured(update))
        group_wire = update.group_wire_bytes()
        group_dense = update.group_dense_bytes()
        dense = plan_for(params).total_elems * 4
        codec = "structured" if spec is None else f"structured:{spec.codec}"
    elif spec is not None:
        from .agg_engine import plan_for

        total = plan_for(params).total_elems
        c_train_bytes = compressed_wire_bytes(total, spec)
        codec = spec.codec
        dense = total * 4
    return RoundMessageLog(
        s_msg_train_bytes=weight_bytes,
        c_msg_train_bytes=c_train_bytes,
        s_msg_aggreg_bytes=weight_bytes,
        c_msg_test_bytes=len(serialize_metrics(metrics_example)),
        codec=codec,
        c_msg_train_dense_bytes=dense,
        group_wire_bytes=group_wire,
        group_dense_bytes=group_dense,
    )


def to_cost_model_sizes(log: RoundMessageLog) -> MessageSizes:
    """Bridge real measured sizes into the scheduler's cost model.

    Always the *wire* sizes — with compression enabled the c_msg_train
    term is the compressed frame, which is what the inter-cloud link
    actually carries (the dense equivalent stays a reporting-only
    field)."""
    return MessageSizes(
        s_msg_train_gb=log.s_msg_train_bytes / 1e9,
        s_msg_aggreg_gb=log.s_msg_aggreg_bytes / 1e9,
        c_msg_train_gb=log.c_msg_train_bytes / 1e9,
        c_msg_test_gb=log.c_msg_test_bytes / 1e9,
    )


def model_weight_bytes(params: Any) -> int:
    return int(pytree_num_bytes(params))
