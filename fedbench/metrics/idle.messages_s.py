"""Seconds a round in which the card ran nothing during the message
accounting (the program's span ``fl.messages`` over the trace's device
events).  The mean over the traced rounds."""

from fedbench.phases import per_round


def read(rec):
    return per_round(rec, "idle", "fl.messages", on_card=True)
