"""Seconds a round the server folds (``agg_time_s``): with compression
this holds the silos' encodes and the wire framing.  The mean over the
window's untraced rounds."""


def read(rec):
    rounds = rec["rounds"]
    return sum(r["fold_s"] for r in rounds) / len(rounds)
