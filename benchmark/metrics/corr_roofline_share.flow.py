"""The correlation kernel's share of its roofline in the profiled solves:
each lookup's bound (`counts.raft.lookup_bound_s`: bytes from the shapes,
operations the dots its window positions need, counted on the plain
reference's solve of a batch of the window) over the profiler's device time
of the kernels named here."""

from benchmark.counts import raft

SOURCE = "device_trace"
LAYER = "corr kernel"
MOVES = "flow_pairs_per_s"
KERNELS = ("corr_lookup_kernel", "corr_lookup_tc_kernel")


def read(run):
    t = run.trace
    if not t:
        return None
    kernel_s = sum(d for n, d in t["ops"] if any(k in n for k in KERNELS))
    if kernel_s <= 0:
        return None
    H, W = run.config["frame_size"]
    H8, W8 = H // 8, W // 8
    iters = run.config["raft"]["iters"]
    dots = run.window["dots_per_direction_lookup"]
    bound = sum(iters * raft.lookup_bound_s(b, H8, W8, b * dots)
                for b in t["batches"])
    return 100.0 * bound / kernel_s
