"""GiB a round that ``measure_messages`` serializes (the program's
counter ``fl.bytes.serialized``: every frame it builds).  The mean over
the traced rounds."""

from fedbench.phases import per_round


def read(rec):
    return per_round(rec, "counters", "fl.bytes.serialized", 2.0 ** -30)
