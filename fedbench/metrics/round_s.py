"""Seconds a round: the window's whole host time, ending in a device
synchronize, over the rounds in it."""


def read(rec):
    return rec["window_s"] / len(rec["rounds"])
