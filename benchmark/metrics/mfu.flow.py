"""The whole flow solve's share of the card's bf16 peak over the window:
the model FLOPs a direction of the flow model the configuration names
(`benchmark/flowmodels/<name>.py`; RAFT's count every convolution, the
lookups' window dots, the upsampling, and no all-pairs volume) times the
directions solved, over the window's seconds."""

from benchmark import flowmodels
from benchmark.counts import peaks

SOURCE = "host_clock"
LAYER = "flow"
MOVES = "flow_pairs_per_s"


def read(run):
    w = run.window
    if not w.get("directions"):
        return None
    flops = flowmodels.of(run.config).direction_flops(run.config) * w["directions"]
    return 100.0 * flops / (w["seconds"] * peaks.BF16_FLOPS)
