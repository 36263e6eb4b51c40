"""The card's peak allocated memory over the window's first
``harness.PEAK_ROUNDS`` rounds (``torch.cuda.max_memory_allocated`` after a
reset at the window's start), in GiB: the server and its silos, trained
one after another, share the card."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec["peak_bytes"] else None
