"""Seconds a round in which the card ran nothing while a silo trained (the
program's spans ``fl.train`` over the trace's device events, user
annotations left out).  The mean over the traced rounds."""

from fedbench.phases import per_round


def read(rec):
    return per_round(rec, "idle", "fl.train", on_card=True)
