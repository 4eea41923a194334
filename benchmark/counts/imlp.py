"""The atlas fit's work a step, counted from the configuration's widths:
what the algorithm must compute and move, whatever implements it.

Each network query is one matmul chain over its rows: every coordinate
variant of the step's samples that the loss reads.  Its model FLOPs are
the forward products, the weight gradients of every layer and the input
gradients through every layer but the first (and through the first where
the input needs one: the atlas, whose input is the mappings' output).  The
skip input is detached, so its rows of a skip layer get no input gradient.
A backward that recomputes the forward (remat) or reads a stash does the
same algorithmic work: neither the recompute nor a stash's bytes count.

The bound of a step's chain calls is max(FLOPs / bf16 peak, bytes / HBM
rate) over all its calls, the bytes being each call's inputs read once and
outputs written once: the f32 encoded input, the bf16 weights and f32
biases, the f32 output; in the backward the input again, the f32 output
gradient, the weights, the f32 weight gradients and, where needed, the f32
input gradient.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..reference.nla import layer_dims, network_specs, phase
from . import peaks


def rows(atlas: dict, dual: bool, with_global: bool) -> Dict[str, Tuple[int, bool]]:
    """{network: (rows a step for one video, input gradient needed)}.

    mapping1 (and mapping2): base, x+1, y+1, y-1, x-1, the forward and
    backward flow matches, and with global rigidity its two offsets;
    atlas: base, x+1, y+1 of each layer's uv; alpha: base, x+1, y+1 and
    the two flow matches."""
    B = atlas["samples_batch"]
    variants = 9 if with_global else 7
    out = {"mapping1": (variants * B, False), "atlas": (3 * B, True)}
    if dual:
        out["mapping2"] = (variants * B, False)
        out["atlas"] = (6 * B, True)
        out["alpha"] = (5 * B, False)
    return out


def chain_work(dims: List[Tuple[int, int]], skips, n: int, need_dx: bool
               ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one chain's forward and backward over n rows."""
    macs = [a * b for a, b in dims]
    E = dims[0][0]
    O = dims[-1][1]
    flops = 2.0 * n * sum(macs)                 # forward
    flops += 2.0 * n * sum(macs)                # weight gradients
    for k in range(len(dims) - 1, -1, -1):      # input gradients
        if k == 0 and not need_dx:
            continue
        kept = dims[k][0] - (E if k in skips and k > 0 else 0)
        flops += 2.0 * n * kept * dims[k][1]
    params = sum(macs) + sum(b for _, b in dims)
    w_bytes = 2.0 * sum(macs) + 4.0 * sum(b for _, b in dims)
    fwd = 4.0 * n * E + w_bytes + 4.0 * n * O
    bwd = 4.0 * n * E + 4.0 * n * O + w_bytes + 4.0 * params + (4.0 * n * E if need_dx else 0.0)
    return flops, fwd + bwd


def phase_work(atlas: dict, dual: bool, with_global: bool, videos: int = 1
               ) -> Tuple[float, float]:
    """(FLOPs, bytes) of every chain call of a step, with or without the
    global rigidity's two queries."""
    specs = network_specs(atlas, dual)
    flops = nbytes = 0.0
    for name, (n, need_dx) in rows(atlas, dual, with_global).items():
        f, b = chain_work(layer_dims(specs[name]), specs[name]["skips"], n, need_dx)
        flops += f
        nbytes += b
    return videos * flops, videos * nbytes


def step_work(atlas: dict, dual: bool, iteration: int, videos: int = 1
              ) -> Tuple[float, float]:
    """(FLOPs, bytes) of every chain call of the step at `iteration`."""
    return phase_work(atlas, dual, phase(atlas, dual, iteration)[0], videos)


def _bound_s(flops: float, nbytes: float) -> float:
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)


def step_bound_s(atlas: dict, dual: bool, iteration: int, videos: int = 1) -> float:
    return _bound_s(*step_work(atlas, dual, iteration, videos))


def _per_phase(atlas: dict, dual: bool, spans) -> Dict[bool, int]:
    """{global rigidity on: steps} over the steps [start, end) of each span."""
    counts: Dict[bool, int] = {}
    for start, end in spans:
        for it in range(start, end):
            key = phase(atlas, dual, it)[0]
            counts[key] = counts.get(key, 0) + 1
    return counts


def steps_flops(atlas: dict, dual: bool, spans, videos: int = 1) -> float:
    """Model FLOPs of the steps [start, end) of each span."""
    return sum(n * phase_work(atlas, dual, g, videos)[0]
               for g, n in _per_phase(atlas, dual, spans).items())


def steps_bound_s(atlas: dict, dual: bool, spans, videos: int = 1) -> float:
    """The chain calls' bound summed over the steps of each span."""
    return sum(n * _bound_s(*phase_work(atlas, dual, g, videos))
               for g, n in _per_phase(atlas, dual, spans).items())
