"""Seconds a round in which the card ran nothing inside the SSD scan: the
program's spans ``ssm.scan`` (each forward scan, its kernel and torch
inter-chunk part) and ``ssm.scan.bwd`` (each backward kernel's call, on
autograd's thread) over the trace's device events; the two never
overlap, so their idle seconds add.  The mean over the traced rounds;
silent where the program records neither span."""

from fedbench.phases import per_round

SPANS = ("ssm.scan", "ssm.scan.bwd")


def read(rec):
    parts = [per_round(rec, "span_idle_s", name, on_card=True) for name in SPANS]
    parts = [p for p in parts if p is not None]
    return sum(parts) if parts else None
