"""Seconds from process start to the first timed round: imports, weights
and data made on the card, kernels built or loaded, the warm-up round."""


def read(rec):
    return rec["setup_s"]
