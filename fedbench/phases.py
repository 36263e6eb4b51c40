"""The program's own spans laid over a ``torch.profiler`` trace.

The port records its phases as spans and counters
(``repro_torch.utils.spans``): ``fl.round``, and inside it ``fl.train``
(each silo), ``fl.fold``, ``fl.evaluation``, ``fl.checkpoint`` and
``fl.messages``, with ``fl.fold.frame`` inside the fold, and the counters
``fl.bytes.serialized`` and ``fl.alloc.reserved``.  :func:`join` lays
them on the trace's device timeline: the device's busy intervals are its
events other than user annotations, merged, and each phase's idle seconds
are the part of its spans' union in which the device ran nothing; the
same is taken for every span name recorded (``span_idle_s``), so that a
span the program adds gets its idle reading from a new reader alone.  The
result is what the metrics ``messages.span_s``,
``messages.serialized_gib``, ``fold.frame_s``, ``idle.train_s``,
``idle.fold_s``, ``idle.messages_s`` and ``alloc.growth_gib`` read, as
``rec["phases"]``: a traced run (``harness.run``) enables the spans
around its profile and stores ``join(device_busy(device_events(prof)),
spans.take(), window)`` there while the profile is still alive.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]

# The phases the idle time is put down to; the rest of it lies outside
# all of them.
PHASES = ("fl.train", "fl.fold", "fl.evaluation", "fl.checkpoint", "fl.messages")
# Spans that end in a device synchronize: each ends just after its last
# device work where the two clocks agree.
SYNCED = ("fl.train", "fl.fold", "fl.fold.finalize")
METRICS = ("messages.span_s", "messages.serialized_gib", "fold.frame_s",
           "idle.train_s", "idle.fold_s", "idle.messages_s", "alloc.growth_gib")


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    merged: List[Interval] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def covered(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """Length of the intersection of two merged interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def clip(intervals: Sequence[Interval], window: Interval) -> List[Interval]:
    return [(max(a, window[0]), min(b, window[1])) for a, b in intervals
            if min(b, window[1]) > max(a, window[0])]


def idle(spans_of: Sequence[Interval], busy: Sequence[Interval]) -> int:
    """Nanoseconds of a merged interval list in which the device ran nothing."""
    return sum(b - a for a, b in spans_of) - covered(spans_of, busy)


def device_busy(events: Sequence[Tuple[int, int, bool]]) -> List[Interval]:
    """The device's busy intervals from its events, given as (start ns,
    end ns, is a user annotation): annotations are left out, since they
    are host ranges the profiler projects onto the device's timeline."""
    return merge([(a, b) for a, b, note in events if not note])


def device_events(prof: Any) -> List[Tuple[int, int, bool]]:
    """A profile's device events as (start ns, end ns, is a user annotation)."""
    from torch.autograd import DeviceType

    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def join(busy: Sequence[Interval], taken: Any, window: Interval) -> Dict[str, Any]:
    """The spans of ``taken`` (``repro_torch.utils.spans.Taken``) over the
    device's merged busy intervals, within ``window``; ``busy`` and
    ``window`` are on the profiler's clock, the spans on theirs until
    ``taken.offset_ns`` moves them.

    Returns ``rounds`` (the ``fl.round`` spans), ``window_s``,
    ``busy_s`` and ``idle_s`` of the window, ``span_s`` (each span
    name's seconds, all its spans summed), ``idle`` (the window's idle
    seconds inside the spans of each of :data:`PHASES` that has any,
    and ``outside`` them all), ``span_idle_s`` (the window's idle
    seconds inside the union of each span name's spans, for every name
    recorded), ``counters`` (each counter summed over
    the rounds) and ``lag_s`` (for each span of :data:`SYNCED`, its end
    less the end of the last device work inside it; None where it has
    none)."""
    off = taken.offset_ns
    busy = clip(merge(busy), window)
    by_name: Dict[str, List[Interval]] = {}
    for s in taken.spans:
        by_name.setdefault(s.name, []).append((s.start_ns + off, s.end_ns + off))
    name_ivs = {n: clip(merge(iv), window) for n, iv in by_name.items()}
    phase_ivs = {p: name_ivs.get(p, []) for p in PHASES}
    idle_by = {p: idle(iv, busy) / 1e9 for p, iv in phase_ivs.items() if p in by_name}
    inside = merge([x for iv in phase_ivs.values() for x in iv])
    window_ns = window[1] - window[0]
    busy_ns = sum(b - a for a, b in busy)
    outside = [window] if not inside else clip(
        [(window[0], inside[0][0])] + [(x[1], y[0]) for x, y in zip(inside, inside[1:])]
        + [(inside[-1][1], window[1])], window)
    idle_by["outside"] = idle(outside, busy) / 1e9
    lags: Dict[str, List[Optional[float]]] = {}
    for name in SYNCED:
        for a, b in by_name.get(name, []):
            ends = [e for _, e in busy if a <= e <= b]
            lags.setdefault(name, []).append((b - max(ends)) / 1e9 if ends else None)
    return {
        "rounds": len(by_name.get("fl.round", [])),
        "window_s": window_ns / 1e9,
        "busy_s": busy_ns / 1e9,
        "idle_s": (window_ns - busy_ns) / 1e9,
        "span_s": {n: sum(b - a for a, b in iv) / 1e9 for n, iv in by_name.items()},
        "idle": idle_by,
        "span_idle_s": {n: idle(iv, busy) / 1e9 for n, iv in name_ivs.items()},
        "counters": {n: sum(v.values()) for n, v in taken.counters.items()},
        "lag_s": lags,
    }


# ---------------------------------------------------------------------------
# Reading one phase a round (the metrics' shared arithmetic)
# ---------------------------------------------------------------------------

def per_round(rec: Dict[str, Any], kind: str, name: str, scale: float = 1.0,
              on_card: bool = False) -> Optional[float]:
    """``rec["phases"][kind][name]`` a round, times ``scale``; None where
    the run has no phases, no rounds or no such entry, or, with
    ``on_card``, did not run on the card."""
    ph = rec.get("phases")
    if not ph or not ph.get("rounds") or name not in ph.get(kind, {}):
        return None
    if on_card and rec.get("device") != "cuda":
        return None
    return ph[kind][name] / ph["rounds"] * scale
