"""Mamba-2 LM: 6 N a trained token (2 N forward, 4 N backward), 2 N an
evaluated token, N counting every parameter (the tied embedding is the
unembedding's product; the convolution's weights are its multiply-adds;
the norm scales, D, dt_bias and A_log, under 0.01 % of N, are counted
alike); plus the SSD's chunked products a token and layer forward, where
the decay is not zero (s <= l): (Q + 1) P a head within the chunk (the
causal half of (L o C B^T)(x dt)), 2 P N a head into the chunk's state
and 2 P N a head out of the state carried in, and (Q + 1) N for C B^T,
which the heads share; three times that trained."""


def ssd_flops_per_token(cfg: dict) -> float:
    """The SSD's forward products a token and layer."""
    E = cfg["expand"] * cfg["d_model"]
    P, N, Q = cfg["headdim"], cfg["d_state"], cfg["chunk_size"]
    H = E // P
    return float(H * ((Q + 1) * P + 4 * P * N) + (Q + 1) * N)


def round_flops(cfg: dict, traffic: dict, n_params: int, n_trained: int) -> float:
    S, layers = traffic["context"], cfg["n_layer"]
    silos, epochs = traffic["silos"], traffic["local_epochs"]
    train_tokens = sum(n for n, _ in silos) * S * epochs
    eval_tokens = sum(n for _, n in silos) * S
    ssd = ssd_flops_per_token(cfg) * layers
    return train_tokens * (6.0 * n_trained + 3 * ssd) + eval_tokens * (2.0 * n_params + ssd)
