"""Attention's forward on (B, S, H, D) queries, keys and values in
bfloat16: Q K^T and P V, the causal half (the diagonal included) or the
full square."""


def work(B: int, S: int, H: int, D: int, causal: bool = True) -> dict:
    flops = 2.0 * B * H * D * S * (S + 1) if causal else 4.0 * B * H * D * S * S
    return {"flops": flops, "bytes": 2.0 * 4 * B * S * H * D}
