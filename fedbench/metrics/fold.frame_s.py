"""Seconds a round the fold spends building wire frames on the host only
to count their bytes (the program's spans ``fl.fold.frame``, in
``CompressedUpdate.wire_bytes`` and ``StructuredUpdate.wire_bytes``).
On a card the first frame's device-to-host copy also waits for the
silos' encodes, whose kernels are still queued: the reading holds that
wait too.  The mean over the traced rounds."""

from fedbench.phases import per_round


def read(rec):
    return per_round(rec, "span_s", "fl.fold.frame")
