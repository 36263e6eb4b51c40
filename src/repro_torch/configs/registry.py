"""--arch registry: id -> ModelConfig for the 10 assigned architectures,
plus the paper's own three FL applications (control-plane configs)."""
from __future__ import annotations

from typing import Dict

from .base import INPUT_SHAPES, InputShape, ModelConfig
from .deepseek_7b import CONFIG as DEEPSEEK_7B
from .deepseek_moe_16b import CONFIG as DEEPSEEK_MOE_16B
from .granite_moe_1b_a400m import CONFIG as GRANITE_MOE_1B
from .internlm2_1_8b import CONFIG as INTERNLM2_1_8B
from .internvl2_2b import CONFIG as INTERNVL2_2B
from .jamba_1_5_large_398b import CONFIG as JAMBA_1_5_LARGE
from .mamba2_130m import CONFIG as MAMBA2_130M
from .olmo_1b import CONFIG as OLMO_1B
from .whisper_small import CONFIG as WHISPER_SMALL
from .yi_9b import CONFIG as YI_9B

ARCHITECTURES: Dict[str, ModelConfig] = {
    "internlm2-1.8b": INTERNLM2_1_8B,
    "yi-9b": YI_9B,
    "deepseek-moe-16b": DEEPSEEK_MOE_16B,
    "internvl2-2b": INTERNVL2_2B,
    "whisper-small": WHISPER_SMALL,
    "mamba2-130m": MAMBA2_130M,
    "jamba-1.5-large-398b": JAMBA_1_5_LARGE,
    "olmo-1b": OLMO_1B,
    "granite-moe-1b-a400m": GRANITE_MOE_1B,
    "deepseek-7b": DEEPSEEK_7B,
}

# Sliding-window profile for long_500k on full-attention decoder archs
# (DESIGN.md §4): bounds the attended KV working set at 8192.
LONG_CONTEXT_WINDOW = 8192


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHITECTURES:
        raise KeyError(f"unknown --arch {arch!r}; options: {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[arch]


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown --shape {name!r}; options: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


def shape_supported(cfg: ModelConfig, shape: InputShape) -> bool:
    """Skips recorded in DESIGN.md §4 (whisper-small x long_500k)."""
    return shape.name not in cfg.skip_shapes


def long_context_config(cfg: ModelConfig) -> ModelConfig:
    """The config actually lowered for long_500k: SSM/hybrid run natively;
    full-attention decoders get the sliding-window variant."""
    if cfg.arch_type in ("ssm",):
        return cfg
    if cfg.arch_type == "hybrid":
        # Attention layers in the hybrid also get the window (Jamba itself
        # caps attention context); Mamba layers are context-free anyway.
        return cfg.with_overrides(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg.with_overrides(sliding_window=LONG_CONTEXT_WINDOW)
