"""olmo-1b — dense MHA with non-parametric LayerNorm [arXiv:2402.00838]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    arch_type="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,          # MHA
    d_ff=8192,
    vocab_size=50304,
    head_dim=128,
    norm_type="nonparametric",
    tie_embeddings=True,
    citation="arXiv:2402.00838",
)
