"""A profiled window of a run, reduced to what the per-layer metrics read.

The window runs under `torch.profiler` (CPU and CUDA activities) inside a
`record_function("bench/window")` range; the harness marks its own calls
into the program with `record_function("bench/<span>")`.  From the trace
this keeps:

  * every device operation (kernels, copies, sets) with its name, start and
    length; user annotations on the device's timeline are left out, since
    they span operations already counted;
  * the window's length on the host's clock and the seconds in which some
    device operation ran (the union of their intervals);
  * the idle gaps on the device, each named by what the host was doing when
    it began: gaps under `SHORT_GAP_US` are the device's own spacing between
    operations queued ahead ("between_ops"), longer ones take the harness
    span around them and the runtime call the host was in.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

SHORT_GAP_US = 50.0
PREFIX = "bench/"


class Session:
    """A profiled window opened and closed by calls (`start`, `stop`), for a
    window that begins and ends inside the program's own loop; on `stop`
    `result` holds the reduced trace (`reduce`).  The device is synchronised
    at both ends, and the window, and `name` as the harness span around
    the program's work, are ranges of the trace."""

    def __init__(self, result: dict, name: str):
        self.result = result
        self.name = name

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        _sync()
        cuda = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
        self.prof = profile(activities=[ProfilerActivity.CPU] + cuda)
        self.prof.start()
        self.ranges = [record_function(PREFIX + "window"),
                       record_function(PREFIX + self.name)]
        for r in self.ranges:
            r.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        _sync()
        t1 = time.perf_counter()
        for r in reversed(self.ranges):
            r.__exit__(None, None, None)
        self.prof.stop()
        self.result.update(reduce(self.prof.events(), t1 - self.t0))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profiled(result: dict):
    """Profile the block as one window (see `Session`)."""
    session = Session(result, "harness")
    session.start()
    try:
        yield
    finally:
        session.stop()


def span(name: str):
    """A harness span around a call into the program."""
    from torch.profiler import record_function

    return record_function(PREFIX + name)


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, the gaps between covered stretches)."""
    covered, gaps = 0.0, []
    end = None
    for s, e in sorted(intervals):
        if end is None:
            covered += e - s
            end = e
        elif s > end:
            gaps.append((end, s))
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    return covered, gaps


def reduce(events, wall_s: float) -> dict:
    from torch.autograd import DeviceType

    device_ops, host_spans, runtime = [], [], []
    window = None
    for ev in events:
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                device_ops.append((ev.name, tr.start, tr.end - tr.start))
        elif ev.name.startswith(PREFIX):
            if ev.name == PREFIX + "window":
                window = (tr.start, tr.end)
            else:
                host_spans.append((ev.name[len(PREFIX):], tr.start, tr.end))
        elif ev.name.startswith("cuda"):
            runtime.append((ev.name, tr.start, tr.end))
    if window is None:
        raise RuntimeError("the profiled window has no bench/window range")
    w0, w1 = window
    ops = [(n, s, d) for n, s, d in device_ops if s < w1 and s + d > w0]
    busy_us, gaps = _union([(max(s, w0), min(s + d, w1)) for _, s, d in ops])
    if ops:
        first = min(s for _, s, _ in ops)
        last = max(s + d for _, s, d in ops)
        gaps = [(w0, first)] + gaps + [(last, w1)]
    else:
        gaps = [(w0, w1)]
    named: Dict[str, float] = {}
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        name = ("between_ops" if g1 - g0 < SHORT_GAP_US
                else _host_at(g0, host_spans, runtime))
        named[name] = named.get(name, 0.0) + (g1 - g0) * 1e-6
    by_name: Dict[str, float] = {}
    for n, _, d in ops:
        by_name[n] = by_name.get(n, 0.0) + d * 1e-6
    return {"window_s": wall_s, "traced_s": (w1 - w0) * 1e-6,
            "busy_s": busy_us * 1e-6, "ops": [(n, d * 1e-6) for n, _, d in ops],
            "op_seconds": by_name, "idle_gaps": named}


def _host_at(t: float, spans, runtime) -> str:
    """`<innermost harness span>/<runtime call>` at host time t."""
    inner: Optional[Tuple[str, float, float]] = None
    for s in spans:
        if s[1] <= t < s[2] and (inner is None or s[1] >= inner[1]):
            inner = s
    call = None
    for r in runtime:
        if r[1] <= t < r[2]:
            call = r[0]
            break
    return f"{inner[0] if inner else 'harness'}/{call or 'python'}"


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle gaps by
    name, at most `top` of each, longest first."""
    ops = sorted(trace["op_seconds"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
