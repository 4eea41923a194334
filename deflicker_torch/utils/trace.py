"""Spans and counters of the port's own work, kept in memory.

  * `span(name)`: a context manager around a stretch of host work at a
    boundary of the flow batch, the fit loop or the CUDA graphs.  Off, it
    is one flag test and a shared no-op context.  On, it enters
    `torch.profiler.record_function("deflicker/<name>")`, so a profiler's
    trace (`DEFLICKER_PROFILE`'s Chrome trace among them) holds the span
    beside the device operations on one clock, and it appends
    `(name, parent, t0_ns, t1_ns)` to the log: `parent` is the name of the
    enclosing span (None at the top), the times are
    `time.perf_counter_ns()` (CLOCK_MONOTONIC).  The profiler stamps its
    events on the Unix clock; `clock_offset_ns()` is what to add to a
    logged time to read it there.  Whether a span records is decided when
    it is entered.
  * `count(name, n=1)`, `add_seconds(name, s)`: counters, always on, one
    dict update each.  They sit at a fit's start and at the graphs'
    warm-ups, captures and states, never in a replay loop or a kernel's
    call path.
  * Spans record while a torch.profiler records, or inside `recording()`.
  * `spans()`, `counters()` read the log and the counters; `clear()` resets
    both.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "deflicker/"

Span = Tuple[str, Optional[str], int, int]

_profiling = torch.autograd._profiler_enabled
_recording = 0
_log: List[Span] = []
_counters: Dict[str, float] = {}
_stack: List[str] = []          # the names of the open spans


def _clock_offset() -> int:
    a = time.perf_counter_ns()
    unix = time.time_ns()
    b = time.perf_counter_ns()
    return unix - (a + b) // 2


_offset_ns = _clock_offset()
_OFF = contextlib.nullcontext()     # every span that does not record


class _On:
    __slots__ = ("name", "parent", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent = _stack[-1] if _stack else None
        _stack.append(self.name)
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _stack.pop()
        _log.append((self.name, self.parent, self.t0, t1))
        return False


def enabled() -> bool:
    """Whether a span entered now records."""
    return _recording > 0 or _profiling()


def span(name: str):
    if not _recording and not _profiling():
        return _OFF
    return _On(name)


@contextlib.contextmanager
def recording():
    """Spans record inside the block, with or without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def add_seconds(name: str, s: float) -> None:
    _counters[name] = _counters.get(name, 0.0) + s


def spans() -> List[Span]:
    return list(_log)


def counters() -> Dict[str, float]:
    return dict(_counters)


def clock_offset_ns() -> int:
    """Unix ns (the profiler's clock) minus `perf_counter_ns()` at the last
    `clear()`."""
    return _offset_ns


def clear() -> None:
    global _offset_ns
    _log.clear()
    _counters.clear()
    _offset_ns = _clock_offset()
