"""yi-9b — llama-arch dense GQA [arXiv:2403.04652]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    arch_type="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    microbatches=4,
    citation="arXiv:2403.04652",
)
