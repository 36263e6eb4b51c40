"""whisper-small — encoder-decoder ASR; conv/mel frontend is a STUB
(input_specs supplies frame embeddings) [arXiv:2212.04356].

long_500k is SKIPPED for this arch (DESIGN.md §4): a 524k-token decoder
state has no meaning for an enc-dec whose decoder transcribes a <=1500-
frame (30 s) window.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="encdec",
    n_layers=12,            # decoder layers
    n_encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,          # MHA
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    encoder_seq=1500,
    max_decoder_seq=32768,  # sized for the assigned decode_32k shape

    norm_type="layernorm",
    tie_embeddings=True,
    citation="arXiv:2212.04356",
    skip_shapes=("long_500k",),
)
