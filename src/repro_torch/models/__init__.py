"""Models: the paper's FL application models (``fl_models``), the model
zoo behind one ``ModelFamily`` API (``api``: the dense, MoE, VLM, SSM,
hybrid and encoder-decoder families), and the federated-LoRA adapter helpers."""
from .api import ModelFamily, get_model
from .fl_models import (
    LoRAConfig,
    inject_lora,
    lora_adapter_schema,
    lora_effective,
    lora_merge_hook,
    merge_lora,
)

__all__ = [
    "LoRAConfig",
    "ModelFamily",
    "get_model",
    "inject_lora",
    "lora_adapter_schema",
    "lora_effective",
    "lora_merge_hook",
    "merge_lora",
]
