"""Host seconds the program spent starting its fits over the run: its
counter `fit.start_s`, the time of each fit's `fit/start` (the graphs'
state made or loaded, Adam's state set), with no sync added.  The first
fit of a process makes the state and its optimizer, and a process's first
`torch.optim.Adam` imports `torch._dynamo`; that start is set-up.  A later start
loads a kept state and adds milliseconds."""

SOURCE = "program_counter"
LAYER = "fit loop"
MOVES = "setup_s"
KEY = "fit.start_s"


def value(counters):
    """The fits' start seconds; None where no fit started."""
    return counters.get(KEY)


def read(run):
    if not run.trace or not run.trace["ops"]:
        return None
    try:
        from deflicker_torch.utils import trace
    except ImportError:         # a program without counters
        return None
    return value(trace.counters())
