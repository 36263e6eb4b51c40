"""deepseek-7b — llama-arch dense MHA [arXiv:2401.02954]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    arch_type="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,          # MHA
    d_ff=11008,
    vocab_size=102400,
    head_dim=128,
    microbatches=4,
    # MHA (kv=32) at decode_32k carries a 2.06 TB global KV cache; int8
    # cache storage (per-token absmax scales) brings decode from 31.1 GB
    # to 11.6 GB/chip (EXPERIMENTS.md §Perf Pair-2, iteration 3).
    kv_cache_dtype="int8",
    citation="arXiv:2401.02954",
)
