"""GiB a round by which the card's allocator grew its reserve (the
program's counter ``fl.alloc.reserved``: ``torch.cuda.memory_reserved``
at the end of ``fl.round`` less at its start).  The mean over the traced
rounds."""

from fedbench.phases import per_round


def read(rec):
    return per_round(rec, "counters", "fl.alloc.reserved", 2.0 ** -30)
