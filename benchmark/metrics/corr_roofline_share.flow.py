"""The correlation kernel's share of its roofline in the profiled solves:
each lookup's bound (the flow model's `lookup_bound_s`, for the RAFT family
`counts/raft.py`'s: bytes from the shapes, operations the dots its window
positions need, counted on the plain reference's solve of a batch of the
window) over the profiler's device time of the kernels named here."""

from benchmark import flowmodels

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
    model = flowmodels.of(run.config)
    iters = model.settings(run.config)["iters"]
    dots = run.window["dots_per_direction_lookup"]
    bound = sum(iters * model.lookup_bound_s(b, H8, W8, b * dots)
                for b in t["batches"])
    return 100.0 * bound / kernel_s
