"""Seconds a round in which the card ran nothing during the fold (the
program's span ``fl.fold``, the silos' encodes and the wire framing
included, over the trace's device events).  The mean over the traced
rounds."""

from fedbench.phases import per_round


def read(rec):
    return per_round(rec, "idle", "fl.fold", on_card=True)
