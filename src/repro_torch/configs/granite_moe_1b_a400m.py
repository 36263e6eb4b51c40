"""granite-moe-1b-a400m — 32 experts top-8, fine-grained d_ff=512
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,               # per-expert width
    vocab_size=49155,
    head_dim=64,
    n_experts=32,
    top_k=8,
    moe_every=1,
    tie_embeddings=True,
    microbatches=4,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
