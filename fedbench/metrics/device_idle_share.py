"""Percent of the traced rounds' host time in which no operation ran on
the card (``torch.profiler``'s device events, their intervals merged)."""


def read(rec):
    t = rec["trace"]
    if t is None or rec["device"] != "cuda" or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
