"""Attention's backward from the forward's log-sum-exp: Q K^T again, then
dV, dP, dQ and dK, 2.5 times the forward's products; reads Q, K, V, O and
dO, writes dQ, dK and dV, all bfloat16."""


def work(B: int, S: int, H: int, D: int, causal: bool = True) -> dict:
    fwd = 2.0 * B * H * D * S * (S + 1) if causal else 4.0 * B * H * D * S * S
    return {"flops": 2.5 * fwd, "bytes": 2.0 * 8 * B * S * H * D}
