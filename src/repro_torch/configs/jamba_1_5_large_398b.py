"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave with MoE
(16 experts, top-2, every other layer) [arXiv:2403.19887].

398 B total / ~94 B active parameters. Optimizer states are kept in bf16
(p+m+v = 6 B/param); fp32 Adam would exceed v5e-256's aggregate HBM —
documented deviation, DESIGN.md §3.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    n_experts=16,
    top_k=2,
    moe_every=2,
    attn_period=8,          # 7 mamba : 1 attention
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    optimizer_state_dtype="bfloat16",
    fsdp=True,   # 398 B params: weights+opt must shard over data AND model
    # GSPMD places the FSDP all-gathers at use sites; the explicit in-scan
    # gather variant hits the partitioner's involuntary-remat on
    # slice-then-reshard and materializes whole gathered stacks
    # (EXPERIMENTS.md §Perf iteration 2).
    fsdp_gather_in_scan=False,
    microbatches=8,
    citation="arXiv:2403.19887",
)
