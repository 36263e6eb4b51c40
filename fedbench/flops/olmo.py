"""Decoder LM: 6 N a trained token (2 N forward, 4 N backward), 4 N a
token with a frozen base under adapters (no weight gradients; the
adapters' own products, under 0.5 % at rank 8, are left out), 2 N an
evaluated token; plus causal attention, 2 S d a token and layer forward
(Q K^T and P V over the S / 2 keys a query sees on average), three times
that trained.  N counts every parameter: the tied embedding is the
unembedding's product."""


def round_flops(cfg: dict, traffic: dict, n_params: int, n_trained: int) -> float:
    S, d, layers = traffic["context"], cfg["n_heads"] * cfg["head_dim"], cfg["n_layers"]
    silos, epochs = traffic["silos"], traffic["local_epochs"]
    train_tokens = sum(n for n, _ in silos) * S * epochs
    eval_tokens = sum(n for _, n in silos) * S
    base = n_params - n_trained if traffic.get("adapters") else 0
    dense = n_params - base
    attn = 2.0 * S * d * layers
    return (train_tokens * (6.0 * dense + 4.0 * base + 3 * attn)
            + eval_tokens * (2.0 * n_params + attn))
