"""Seconds a round in ``measure_messages`` (the program's span
``fl.messages``): the weight blob serialized on the host, with the
structured or compressed ``c_msg_train`` frame and the metrics frame.
The mean over the traced rounds."""

from fedbench.phases import per_round


def read(rec):
    return per_round(rec, "span_s", "fl.messages")
