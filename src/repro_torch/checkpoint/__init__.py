from .manager import (
    CheckpointCorruptionError,
    CheckpointInfo,
    ClientCheckpointManager,
    ServerCheckpointManager,
    resolve_freshest,
)
from .serializer import (
    DeserializationError,
    deserialize_pytree,
    pytree_num_bytes,
    serialize_pytree,
)

__all__ = [
    "CheckpointCorruptionError",
    "CheckpointInfo",
    "ClientCheckpointManager",
    "DeserializationError",
    "ServerCheckpointManager",
    "deserialize_pytree",
    "pytree_num_bytes",
    "resolve_freshest",
    "serialize_pytree",
]
