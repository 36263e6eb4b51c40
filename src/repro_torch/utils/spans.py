"""Spans and counters of the program's own phases, kept in memory.

A span is a named interval on the host's clock (``time.perf_counter_ns``)
with the span that encloses it, the round it belongs to and a few
attributes (the silo a client span ran for, where a checkpoint went); a
counter adds up a quantity (bytes serialized, allocator growth) per
round.  Both are recorded only between :func:`enable` and
:func:`disable`, and :func:`take` is their only reader: it returns what
was recorded and clears it.  Nothing is written anywhere.

Off, which is the default, :func:`span` costs one check and returns a
shared no-op object, and :func:`count` returns after one check.
:func:`timer` is the form for call sites whose ``.seconds`` sets a field
of a round's record: off, it reads the clock twice, as the plain timer it
stands for would.  Nothing here touches the card unless spans are on.

No span opens a ``torch.profiler.record_function`` or NVTX range: the
profiler projects such ranges onto the device's timeline, where they
would read as device time.  Instead :func:`enable` takes one offset from
``perf_counter_ns`` onto ``time.time_ns``, the epoch on which
``torch.profiler`` stamps its events, so that :attr:`Taken.offset_ns`
lays the spans and a trace's device events on one clock.

Usage::

    spans.enable()
    with spans.span("fl.round", round=3):
        with spans.timer("fl.train", silo="aws-0") as t:
            ...
        spans.count("fl.bytes.serialized", 4096)
    taken = spans.take()
    spans.disable()
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

_on = False


class Timer:
    """Reads the clock on entry and on exit."""

    __slots__ = ("start_ns", "end_ns")

    def __enter__(self) -> "Timer":
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.end_ns = time.perf_counter_ns()

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Span(Timer):
    """One recorded span.  ``index`` is its place in :attr:`Taken.spans`,
    ``parent`` the index of the span open around it on the same thread
    (None at the top), ``round`` the ``round=`` given to it or else its
    parent's round."""

    __slots__ = ("name", "attrs", "index", "parent", "round")

    def __init__(self, name: str, attrs: Dict[str, Any]) -> None:
        self.name = name
        self.round: Optional[int] = attrs.pop("round", None)
        self.attrs = attrs
        self.parent: Optional[int] = None
        self.end_ns = 0

    def __enter__(self) -> "Span":
        stack = _rec.stack()
        if stack:
            self.parent = stack[-1].index
            if self.round is None:
                self.round = stack[-1].round
        with _rec.lock:
            self.index = len(_rec.spans)
            _rec.spans.append(self)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.end_ns = time.perf_counter_ns()
        _rec.stack().pop()


class _Off:
    """What :func:`span` returns while spans are off."""

    __slots__ = ()
    seconds = 0.0

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


_OFF = _Off()


@dataclasses.dataclass(frozen=True)
class Taken:
    """What :func:`take` hands over: the spans in the order they opened,
    each counter's total by round (``None`` for a count made outside any
    span with a round), and the offset that takes a ``perf_counter_ns``
    reading onto ``time.time_ns``'s epoch."""

    spans: List[Span]
    counters: Dict[str, Dict[Optional[int], int]]
    offset_ns: int


class _Recorder:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.local = threading.local()
        self.spans: List[Span] = []
        self.counters: Dict[str, Dict[Optional[int], int]] = {}
        self.offset_ns = 0

    def stack(self) -> List[Span]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_rec = _Recorder()


def span(name: str, **attrs: Any) -> Any:
    """A context manager that records the span ``name`` while spans are
    on; off, a shared no-op whose ``seconds`` is 0."""
    if not _on:
        return _OFF
    return Span(name, attrs)


def timer(name: str, **attrs: Any) -> Timer:
    """:func:`span` for a call site that reads ``.seconds`` whether or not
    spans are on: off, a plain :class:`Timer`."""
    if not _on:
        return Timer()
    return Span(name, attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the round whose span is open
    on this thread."""
    if not _on:
        return
    stack = _rec.stack()
    rnd = stack[-1].round if stack else None
    with _rec.lock:
        by_round = _rec.counters.setdefault(name, {})
        by_round[rnd] = by_round.get(rnd, 0) + int(n)


def reserved(device: Any) -> Optional[int]:
    """``torch.cuda.memory_reserved`` of a card while spans are on; None
    when they are off or the device is not a card."""
    if not _on:
        return None
    import torch

    device = torch.device(device)
    return torch.cuda.memory_reserved(device) if device.type == "cuda" else None


def _no_span_open(what: str) -> None:
    # A span opened before the records are swapped would give its children
    # a parent index into the old list.
    if _rec.stack():
        raise RuntimeError(f"spans.{what}() called inside the open span "
                           f"{_rec.stack()[-1].name!r}")


def enable() -> None:
    """Start recording anew (what was held is dropped) and take the clock
    offset onto ``time.time_ns``: of five readings, the one whose two
    ``perf_counter_ns`` reads lie closest together.  Call it with no span
    open."""
    global _on
    _no_span_open("enable")
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    with _rec.lock:
        _rec.spans, _rec.counters = [], {}
        _rec.offset_ns = best[1]
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`take`."""
    global _on
    _on = False


def take() -> Taken:
    """The spans and counters recorded so far, which are then cleared.
    Call it with no span open, as between rounds."""
    _no_span_open("take")
    with _rec.lock:
        taken = Taken(_rec.spans, _rec.counters, _rec.offset_ns)
        _rec.spans, _rec.counters = [], {}
    return taken
