"""Host seconds the program spent setting up its CUDA graphs over the run:
its counters `graphs.warmup_s` (the eager warm-up steps and solves before
each capture, with their first calls' loads) and `graphs.capture_s`, with
no sync added.  They count the fit's graphs (`FitGraphs`) in the fit cells
and the RAFT solves' (`InferenceGraphs`) in the flow cell.  All of it is
set-up: the window captures nothing."""

SOURCE = "program_counter"
LAYER = "CUDA graphs"
MOVES = "setup_s"
KEYS = ("graphs.warmup_s", "graphs.capture_s")


def value(counters):
    """Warm-up plus capture seconds; None where neither was counted."""
    if not any(k in counters for k in KEYS):
        return None
    return sum(counters.get(k, 0.0) for k in KEYS)


def read(run):
    if not run.trace or not run.trace["ops"]:
        return None
    try:
        from deflicker_torch.utils import trace
    except ImportError:         # a program without counters
        return None
    return value(trace.counters())
