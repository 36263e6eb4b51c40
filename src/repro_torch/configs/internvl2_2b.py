"""internvl2-2b — VLM: InternViT frontend (STUB: precomputed patch
embeddings via input_specs) + InternLM2-1.8b language backbone
[arXiv:2404.16821]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    arch_type="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    head_dim=128,
    n_image_tokens=256,   # one 448x448 tile through the InternViT projector
    microbatches=2,
    citation="arXiv:2404.16821",
)
