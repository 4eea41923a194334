"""Host milliseconds at a chunk boundary of the fit: from the end of a
chunk's `fit/sync` span (its loss sums back on the host, so the device has
run out of the chunk's steps) to the start of the next chunk's
`fit/replay` span (its steps enqueued), in the mean over the boundaries
whose two ends are in the profiled window's span log.  Meanwhile the
device runs at most the parameter copies that `fit/store` queues.  A
fit's start (`fit/start`) ends a boundary unpaired.  Spans record only
while the profiler runs, so the log holds the window.  The fit cells'
traced window (two chunks of 100 steps around global rigidity's stop)
holds one whole boundary, the loss-phase change at that stop: its next
replay is the other phase's graph, captured at set-up."""

SOURCE = "program_span"
LAYER = "fit loop"
MOVES = "fit_its"


def value(spans):
    """Mean boundary ms of a span log; None without a whole boundary."""
    gaps, synced = [], None
    for name, _, t0, t1 in sorted(spans, key=lambda s: s[2]):
        if name == "fit/sync":
            synced = t1
        elif name == "fit/start":
            synced = None
        elif name == "fit/replay" and synced is not None:
            gaps.append(t0 - synced)
            synced = None
    return 1e-6 * sum(gaps) / len(gaps) if gaps else None


def read(run):
    if not run.trace or not run.trace["ops"]:
        return None
    try:
        from deflicker_torch.utils import trace
    except ImportError:         # a program without spans
        return None
    return value(trace.spans())
