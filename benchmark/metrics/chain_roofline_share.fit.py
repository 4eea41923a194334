"""The chain kernels' share of their roofline in the profiled steps: the
algorithmic bound of every chain call of those steps (`counts.imlp`: the
larger of FLOPs at the bf16 peak and bytes read and written once at the
HBM rate; a recompute or a stash counts nothing) over the profiler's
device time of the kernels named here."""

from benchmark.counts import imlp

SOURCE = "device_trace"
LAYER = "chain kernels"
MOVES = "fit_its"
KERNELS = ("chain_fwd_kernel", "chain_reverse_kernel", "dw_kernel", "reduce_kernel")


def is_chain(name: str) -> bool:
    return any(k in name for k in KERNELS)


def read(run):
    t = run.trace
    if not t:
        return None
    kernel_s = sum(d for n, d in t["ops"] if is_chain(n))
    if kernel_s <= 0:
        return None
    bound = imlp.steps_bound_s(run.config["atlas"], run.config["pipeline"] == "dual",
                               t["spans"], run.window["videos"])
    return 100.0 * bound / kernel_s
