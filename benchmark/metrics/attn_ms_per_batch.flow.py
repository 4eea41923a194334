"""Device milliseconds a profiled flow batch spent in the attention kernels
the flow model names (`ATTENTION_KERNELS`; for GMA the build's two passes
and the 20 aggregations of each solve): their summed device time over the
profiled batches.  Nothing where the flow model has no attention or the
trace holds none of its kernels."""

from benchmark import flowmodels

SOURCE = "device_trace"
LAYER = "attention kernel"
MOVES = "flow_pairs_per_s"


def read(run):
    t = run.trace
    kernels = getattr(flowmodels.of(run.config), "ATTENTION_KERNELS", ())
    if not t or not kernels or not t["batches"]:
        return None
    kernel_s = sum(d for n, d in t["ops"] if any(k in n for k in kernels))
    if kernel_s <= 0:
        return None
    return 1e3 * kernel_s / len(t["batches"])
