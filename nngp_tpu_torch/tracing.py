"""Host spans of the sampler, on the clock of torch.profiler's events.

``span(name)`` marks a stretch of host code; ``record()`` turns the marks
into ``Span``s for its body:

    with tracing.record() as spans, torch.profiler.profile(...) as prof:
        nngp_tpu_torch.run(mc, ...)

A span's times are Unix nanoseconds, the clock of the profiler's kineto
events (``prof.profiler.kineto_results.events()``), so each device
operation and each idle gap of the trace falls inside the host spans that
were open while it ran (``idle_by_span``).  Spans are host code only: they
launch nothing, record no CUDA event and never synchronise.  Outside
``record()`` a span without ``timings`` is one shared object that reads no
clock.  Recording is process-wide: it assumes one thread opens spans, as
the sampler's loop does.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass


@dataclass(slots=True)
class Span:
    name: str
    parent: int                  # index of the enclosing span, -1 for none
    start_ns: int                # Unix nanoseconds
    end_ns: int = 0
    index: int | None = None     # the cycle's start, the iteration's number

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_spans = None          # the list record() fills; None when tracing is off
_open = []             # indices of the spans open now, innermost last
_offset_ns = 0         # time_ns() - perf_counter_ns() at record()'s entry


class _Off:
    """The span of code that is neither timed nor recorded."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Timed:
    __slots__ = ("name", "timings", "index", "t0", "i")

    def __init__(self, name, timings, index):
        self.name, self.timings, self.index = name, timings, index

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        self.i = None
        if _spans is not None:
            self.i = len(_spans)
            _spans.append(Span(self.name, _open[-1] if _open else -1,
                               self.t0 + _offset_ns, index=self.index))
            _open.append(self.i)
        return None

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.timings is not None:
            self.timings[self.name + "_s"] = (t1 - self.t0) * 1e-9
        if self.i is not None:
            _spans[self.i].end_ns = t1 + _offset_ns
            _open.pop()
        return False


def span(name: str, timings: dict | None = None, index: int | None = None):
    """A context manager around one stretch of host code.  With
    ``timings`` it writes ``timings[name + "_s"]``, the stretch's host
    seconds; inside ``record()`` it also appends a ``Span``."""
    if _spans is None and timings is None:
        return _OFF
    return _Timed(name, timings, index)


@contextmanager
def record():
    """Record every span of the body; yields the list the spans go into,
    in the order they opened.  Recording inside a record raises."""
    global _spans, _offset_ns
    if _spans is not None:
        raise RuntimeError("tracing.record() is already recording")
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    spans = []
    _spans = spans
    try:
        yield spans
    finally:
        _spans = None
        _open.clear()


def seconds(spans, name: str) -> float:
    """Seconds of the spans called ``name``, summed."""
    return sum(s.seconds for s in spans if s.name == name)


def self_seconds(spans, i: int) -> float:
    """Span ``i``'s seconds less those of its children."""
    return spans[i].seconds - sum(s.seconds for s in spans if s.parent == i)


def idle_by_span(spans, busy, root: int) -> dict:
    """{span name: seconds} of span ``root``'s stretch in which no device
    operation ran, each piece put down to the innermost span open over it
    (``root``'s own name where none of its descendants is).  ``busy`` holds
    the device operations' (start_ns, end_ns) on the spans' clock.  The
    seconds sum to the root's idle seconds."""
    lo, hi = spans[root].start_ns, spans[root].end_ns
    idle, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in busy
                       if e > lo and s < hi):
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if t < hi:
        idle.append((t, hi))
    # each span's own stretches: its interval less its children's
    kids = {root: []}
    for i in range(root + 1, len(spans)):   # children open after parents
        if spans[i].parent in kids:
            kids[spans[i].parent].append(i)
            kids[i] = []
    own = []
    for i, ch in kids.items():
        t = spans[i].start_ns
        for c in ch:
            own.append((t, spans[c].start_ns, spans[i].name))
            t = spans[c].end_ns
        own.append((t, spans[i].end_ns, spans[i].name))
    own.sort()
    out, j = {}, 0
    for a, b in idle:                        # both lists sorted, disjoint
        while j < len(own) and own[j][1] <= a:
            j += 1
        k = j
        while k < len(own) and own[k][0] < b:
            x, y = max(own[k][0], a), min(own[k][1], b)
            if y > x:
                out[own[k][2]] = out.get(own[k][2], 0.0) + (y - x) * 1e-9
            k += 1
    return out
