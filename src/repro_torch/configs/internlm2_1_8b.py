"""internlm2-1.8b — dense GQA decoder [arXiv:2403.17297]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    head_dim=128,
    microbatches=2,
    citation="arXiv:2403.17297",
    # long_500k profile: sliding-window attention keeps the working set
    # bounded (window 8192) — see DESIGN.md §4.
    sliding_window=None,  # enabled per-shape by the launcher for long_500k
)
