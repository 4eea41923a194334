"""Host milliseconds a flow batch of the profiled window spent in its
upload: the program's `flow/upload` spans (its arrays wrapped, copied to
the device, cast, rounded and padded) summed, over its `flow/batch` spans.
Spans record only while the profiler runs, so the log holds the window."""

SOURCE = "program_span"
LAYER = "flow"
MOVES = "flow_pairs_per_s"
PART = "flow/upload"


def value(spans):
    """Mean ms of `PART` a `flow/batch` in a span log; None without a batch."""
    batches = sum(1 for s in spans if s[0] == "flow/batch")
    if not batches:
        return None
    return 1e-6 * sum(t1 - t0 for name, _, t0, t1 in spans if name == PART) / batches


def read(run):
    if not run.trace or not run.trace["ops"]:
        return None
    try:
        from deflicker_torch.utils import trace
    except ImportError:         # a program without spans
        return None
    return value(trace.spans())
