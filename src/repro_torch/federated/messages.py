"""FL message accounting (paper §3), dense wire path.

The port of ``repro/federated/messages.py``.  Four message kinds per
round: s_msg_train (server -> clients, initial weights), c_msg_train
(client -> server, updated weights), s_msg_aggreg (server -> clients,
aggregated weights), c_msg_test (client -> server, ML metrics).  Byte
sizes are measured from the *actual serialized payloads* — the same v1
blob and msgpack metrics frame the reference sends, so the counts agree
byte for byte.  Compressed and structured ``c_msg_train`` legs come with
the compressed-updates slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..checkpoint._msgpack import packb
from ..checkpoint.serializer import serialize_pytree


@dataclasses.dataclass(frozen=True)
class RoundMessageLog:
    s_msg_train_bytes: int
    c_msg_train_bytes: int
    s_msg_aggreg_bytes: int
    c_msg_test_bytes: int
    # Wire-compression accounting, as in the reference ("none" = raw fp32
    # tree frames, the only codec of this path).
    codec: str = "none"
    c_msg_train_dense_bytes: Optional[int] = None
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


def serialize_metrics(metrics: Dict[str, float]) -> bytes:
    """The wire form of a ``c_msg_test`` payload (msgpack, like weights)."""
    return packb({str(k): float(v) for k, v in metrics.items()})


def measure_messages(params: Any, metrics_example: Dict[str, float]) -> RoundMessageLog:
    """Measure real serialized sizes for one round's dense message set."""
    weight_bytes = len(serialize_pytree(params))
    return RoundMessageLog(
        s_msg_train_bytes=weight_bytes,
        c_msg_train_bytes=weight_bytes,
        s_msg_aggreg_bytes=weight_bytes,
        c_msg_test_bytes=len(serialize_metrics(metrics_example)),
    )
