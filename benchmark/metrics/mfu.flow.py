"""The whole flow solve's share of the card's bf16 peak over the window:
RAFT's model FLOPs a direction (`counts.raft`: every convolution, the
lookups' window dots, the upsampling; no all-pairs volume) times the
directions solved, over the window's seconds."""

from benchmark.counts import peaks, raft

SOURCE = "host_clock"
LAYER = "flow"
MOVES = "flow_pairs_per_s"


def read(run):
    w = run.window
    if not w.get("directions"):
        return None
    H, W = run.config["frame_size"]
    flops = raft.direction_flops(H, W, run.config["raft"]["iters"]) * w["directions"]
    return 100.0 * flops / (w["seconds"] * peaks.BF16_FLOPS)
