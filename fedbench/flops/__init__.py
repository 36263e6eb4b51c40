"""Model FLOPs of one round, by family: ``fedbench/flops/<family>.py``
with ``round_flops(cfg, traffic, n_params, n_trained) -> float``, the
operations the round's training steps and evaluation forwards need,
counted from the configuration and the traffic alone (no recompute)."""
