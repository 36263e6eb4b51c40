"""mamba2-130m — attention-free SSD (state-space duality)
[arXiv:2405.21060]. long_500k decode is O(1) in context length."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                # the SSD block subsumes the FFN
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,       # H = 1536 / 64 = 24 SSD heads
    ssm_chunk=256,
    tie_embeddings=True,
    citation="arXiv:2405.21060",
)
