from .base import INPUT_SHAPES, InputShape, ModelConfig
from .registry import (
    ARCHITECTURES,
    LONG_CONTEXT_WINDOW,
    get_config,
    get_shape,
    long_context_config,
    shape_supported,
)

__all__ = [
    "ARCHITECTURES",
    "INPUT_SHAPES",
    "InputShape",
    "LONG_CONTEXT_WINDOW",
    "ModelConfig",
    "get_config",
    "get_shape",
    "long_context_config",
    "shape_supported",
]
