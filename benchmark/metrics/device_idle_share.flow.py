"""The share of the profiled flow window in which no operation ran on the
device: 1 - (the union of the device operations' intervals) / (the
window's wall time).  User annotations are left out."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = "flow_pairs_per_s"


def read(run):
    t = run.trace
    if not t or not t["ops"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
