"""The whole fit step's share of the card's bf16 peak over the window: the
model FLOPs of every step the window completed (`counts.imlp`: each
network's forward and backward products at its rows; no recompute) over
the window's seconds.  It bounds what a faster kernel can give."""

from benchmark.counts import imlp, peaks

SOURCE = "host_clock"
LAYER = "fit loop"
MOVES = "fit_its"


def read(run):
    w = run.window
    if not w.get("spans"):
        return None
    flops = imlp.steps_flops(run.config["atlas"], run.config["pipeline"] == "dual",
                             w["spans"], w["videos"])
    return 100.0 * flops / (w["seconds"] * peaks.BF16_FLOPS)
