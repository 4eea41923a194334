"""The attention kernels' share of their roofline in the profiled solves:
the bound of the attention a flow model adds (its `attention_bound_s`, for
GMA `counts/gma.py`'s: one q k^T and an attn @ v a GRU iteration on the
tensor cores, q, k, v and the outputs over HBM, nothing of the N^2
attention) summed over the profiled batches, over the profiler's device
time of the kernels the model names (`ATTENTION_KERNELS`).  Nothing where
the flow model has no attention or the trace holds none of its kernels."""

from benchmark import flowmodels

SOURCE = "device_trace"
LAYER = "attention kernel"
MOVES = "flow_pairs_per_s"


def read(run):
    t = run.trace
    model = flowmodels.of(run.config)
    kernels = getattr(model, "ATTENTION_KERNELS", ())
    if not t or not kernels:
        return None
    kernel_s = sum(d for n, d in t["ops"] if any(k in n for k in kernels))
    if kernel_s <= 0:
        return None
    H, W = run.config["frame_size"]
    iters = model.settings(run.config)["iters"]
    bound = sum(model.attention_bound_s(b, H // 8, W // 8, iters) for b in t["batches"])
    return 100.0 * bound / kernel_s
