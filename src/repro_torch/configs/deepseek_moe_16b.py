"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed experts,
top-6, first layer dense [arXiv:2401.06066]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,           # per-expert (fine-grained) width
    vocab_size=102400,
    head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_every=1,
    first_k_dense=1,
    microbatches=4,
    citation="arXiv:2401.06066",
)
