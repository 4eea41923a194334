"""Host milliseconds a flow batch of the profiled window spent in its
download: the program's `flow/download` spans (unpad, the gather across
ranks, the copy back to the host, after `flow/wait` has synchronised the
stream, which only a traced batch does) summed, over its `flow/batch`
spans.  Spans record only while the profiler runs, so the log holds the
window."""

SOURCE = "program_span"
LAYER = "flow"
MOVES = "flow_pairs_per_s"
PART = "flow/download"


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
