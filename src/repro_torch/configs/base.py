"""Model / run configuration schema, the port of ``repro/configs/base.py``.

One `ModelConfig` instance per assigned architecture lives in
`repro_torch/configs/<arch>.py`; the registry maps `--arch` ids to them.
The fields, defaults and ``reduced()`` are the reference's; only the two
dtype properties differ: they map the same dtype strings to
``torch.dtype`` instead of ``jnp.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string (``"bfloat16"``, ``"float32"``, ...) as a
    ``torch.dtype``."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; options: {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str          # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int            # query heads (0 for attention-free)
    n_kv_heads: int         # GQA KV heads (== n_heads for MHA)
    d_ff: int               # dense-FFN hidden size (per-expert size for MoE)
    vocab_size: int
    citation: str = ""      # source paper / model card

    # -- attention ---------------------------------------------------------
    head_dim: Optional[int] = None          # default d_model // n_heads
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None    # long-context profile (SWA)
    attn_logit_softcap: Optional[float] = None

    # -- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_every: int = 1       # MoE on every k-th layer (jamba: 2)
    first_k_dense: int = 0   # leading dense layers (deepseek-moe: 1)
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25

    # -- SSM (Mamba-2 / SSD) --------------------------------------------------
    ssm_state: int = 0       # N, state dimension
    ssm_conv: int = 4        # causal-conv kernel width
    ssm_expand: int = 2      # d_inner = expand * d_model
    ssm_head_dim: int = 64   # P, SSD head dim
    ssm_chunk: int = 256     # SSD chunk length

    # -- hybrid (jamba) --------------------------------------------------------
    attn_period: int = 0     # 1 attention layer per `attn_period` layers

    # -- encoder-decoder (whisper) ---------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 1500  # frame positions after the conv frontend (stub)
    max_decoder_seq: int = 4096  # learned decoder position table size

    # -- VLM (internvl) ----------------------------------------------------------
    n_image_tokens: int = 0  # patch embeddings prepended by the stub frontend

    # -- serving ---------------------------------------------------------------
    # KV-cache storage dtype for decode. "int8" halves cache HBM (per-token
    # per-head absmax scales, dequantized per layer at attention time) —
    # the lever that brings MHA-32 decode (deepseek-7b) under HBM.
    kv_cache_dtype: str = "bfloat16"

    # -- norm / misc ----------------------------------------------------------
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm | nonparametric
    tie_embeddings: bool = False
    dtype: str = "bfloat16"       # activation dtype
    param_dtype: str = "bfloat16"
    optimizer_state_dtype: str = "float32"  # bf16 for jamba-398b (HBM fit)
    remat: bool = True            # activation checkpointing over layers
    microbatches: int = 1         # gradient-accumulation splits of train_4k
    # Dry-run probe mode: unroll every lax.scan so XLA cost_analysis counts
    # loop bodies correctly (scan bodies are otherwise counted ONCE).
    unroll_layers: bool = False
    # Sequence parallelism (Megatron-style): constrain the residual stream
    # to seq@"model" sharding at layer boundaries, so the remat-saved layer
    # inputs (the dominant training activation) shard over the model axis
    # too. XLA re-gathers the sequence where attention needs it.
    sequence_parallel: bool = True
    # FSDP: shard weights/optimizer state over the "data" axis at rest and
    # all-gather per layer inside the scan (explicit with_sharding_constraint
    # — we do not rely on the GSPMD solver to pick the gather). Needed only
    # when model-axis sharding alone cannot fit params+optimizer in HBM
    # (jamba-1.5-large-398b).
    fsdp: bool = False
    # Apply the explicit per-layer gather inside scan_layers. If False the
    # weights stay FSDP-sharded at use sites and GSPMD inserts gathers
    # (the partitioner's involuntary-remat on slice-gather makes the
    # explicit variant materialize whole gathered stacks on some backends).
    fsdp_gather_in_scan: bool = True

    # -- LoRA adapters (federated PEFT) -------------------------------------
    # rank 0 = no adapters.  targets are exact leaf-key names in the
    # model's param tree (see repro.models.fl_models.inject_lora); in
    # adapter-FL runs clients train and ship only the injected ".lora_"
    # leaves while the base stays frozen server-side.
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ()

    # -- shape coverage -----------------------------------------------------
    # Which input shapes this arch supports; long_500k requires sub-quadratic
    # attention (SSM/hybrid native, dense via sliding_window).
    skip_shapes: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.n_heads and self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else (
            self.d_model // max(self.n_heads, 1)
        )

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def weight_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.n_experts == 0:
            return False
        if layer_idx < self.first_k_dense:
            return False
        return (layer_idx - self.first_k_dense) % self.moe_every == 0

    def is_attention_layer(self, layer_idx: int) -> bool:
        """Hybrid archs interleave attention 1:(attn_period-1) with SSM."""
        if self.arch_type != "hybrid":
            return self.n_heads > 0
        # jamba: layer attn_period-1, 2*attn_period-1, ... are attention.
        return (layer_idx % self.attn_period) == (self.attn_period - 1)

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def with_lora(
        self,
        rank: int,
        alpha: float = 16.0,
        targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo"),
    ) -> "ModelConfig":
        """Adapter-FL variant: LoRA factors on the named leaf keys."""
        return dataclasses.replace(
            self, lora_rank=rank, lora_alpha=alpha, lora_targets=targets
        )

    @property
    def lora_enabled(self) -> bool:
        return self.lora_rank > 0

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (<=2 layers, d_model<=512,
        <=4 experts) runnable on CPU."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.n_heads else None,
            remat=False,
        )
        if self.n_experts:
            kw.update(
                n_experts=min(self.n_experts, 4),
                n_shared_experts=min(self.n_shared_experts, 1),
                top_k=min(self.top_k, 2),
                first_k_dense=min(self.first_k_dense, 1),
            )
        if self.ssm_state:
            kw.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=32, ssm_chunk=32)
        if self.arch_type == "hybrid":
            kw.update(attn_period=2, n_layers=2)
        if self.n_encoder_layers:
            kw.update(n_encoder_layers=2, encoder_seq=16, max_decoder_seq=256)
        if self.n_image_tokens:
            kw.update(n_image_tokens=8)
        if self.sliding_window:
            kw.update(sliding_window=16)
        return self.with_overrides(**kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
