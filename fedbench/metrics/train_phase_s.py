"""Seconds a round the silos train: the round record's training phase
less its fold (``train_time_s - agg_time_s``; no post-round hook is
installed), the mean over the window's untraced rounds."""


def read(rec):
    rounds = rec["rounds"]
    return sum(r["train_s"] - r["fold_s"] for r in rounds) / len(rounds)
