"""What the benchmark reads from a ``torch.profiler`` trace, kept in memory.

From the device's events (kernels, copies, fills): the seconds in which
an operation ran on the device (the union of their intervals), the time
by operation name, and the idle gaps between them, each labelled by the
host operation that overlaps it most.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from torch.autograd import DeviceType

Interval = Tuple[int, int]


def _events(prof) -> Tuple[List[Tuple[str, int, int]], List[Tuple[str, int, int]]]:
    """(device events, host events) as (name, start ns, end ns)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        row = (e.name(), start, start + e.duration_ns())
        (dev if e.device_type() == DeviceType.CUDA else host).append(row)
    return dev, host


def _union(rows: List[Tuple[str, int, int]]) -> List[Interval]:
    merged: List[Interval] = []
    for _, a, b in sorted(rows, key=lambda r: r[1]):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _label(gap: Interval, host: List[Tuple[str, int, int]]) -> str:
    best, name = 0, "host Python (no profiled operation)"
    for n, a, b in host:
        if n.startswith("ProfilerStep"):
            continue
        overlap = min(b, gap[1]) - max(a, gap[0])
        if overlap > best:
            best, name = overlap, n
    return name


def summarize(prof, top: int = 10) -> Dict[str, object]:
    """busy_s, the device time by operation name (all of them), and the
    ``top`` longest idle gaps inside the traced span, labelled."""
    dev, host = _events(prof)
    by_name: Dict[str, float] = {}
    for n, a, b in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
    busy = _union(dev)
    gaps: List[Interval] = [(x[1], y[0]) for x, y in zip(busy, busy[1:])]
    if host and busy:
        first, last = min(a for _, a, _ in host), max(b for _, _, b in host)
        gaps += [(first, busy[0][0]), (busy[-1][1], last)]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "device_ops": by_name,
        "idle_gaps": [[_label(g, host), (g[1] - g[0]) / 1e9] for g in gaps],
    }
