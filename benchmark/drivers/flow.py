"""Traffic of kind "flow": RAFT flow of a clip's consecutive pairs, clip
after clip, closed loop.

The pairs go through `RAFTFlow.compute_batch` as the port's
`preprocess_optical_flow` batches them: `pair_batch` pairs a call, forward
and backward directions stacked with `np.stack` into one batch, the tail
batch shorter.  The frames sit in memory as float32 levels: no image
decodes and no `.npy` writes, which are host I/O.  The window closes at the
first batch whose flows are back on the host past `seconds`.

Set-up makes the clip and RAFT's weights on the device from the seed
(the published widths, in the dtype the flow is served in) and solves one
full and one tail batch twice, so that both solves are captured before the
window.  Once the window has closed, a sample of the window's batches drawn
from the seed (two, and the last one) is solved again by the plain
reference and compared flow by flow.

Traffic parameters: "frames" (T).  The configuration gives the clip, the
frame size and the RAFT settings.
"""

from __future__ import annotations

import math
import random
import time
from typing import Dict, List

import numpy as np
import torch

from ..core import trace as tracing
from ..core.seeds import sub_seed
from ..counts import raft as raft_counts
from ..data.clips import frames_uint_levels
from ..reference import raft as reference

SAMPLED = 2            # batches of the window the reference checks, and the last


def make_weights(seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """RAFT's state dict at the published widths: conv weights normal with
    std 1/sqrt(fan_in) from one draw on the device, zero biases, batch norms
    at their initial statistics; in `dtype`."""
    shapes = reference.parameter_shapes()
    total = sum(math.prod(s) for _, s, kind in shapes if kind == "conv_w")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "raft"))
    flat = torch.randn((total,), generator=gen, device=device)
    out, off = {}, 0
    fill = {"conv_b": 0.0, "bn_w": 1.0, "bn_b": 0.0, "bn_mean": 0.0, "bn_var": 1.0}
    for name, shape, kind in shapes:
        if kind == "conv_w":
            n = math.prod(shape)
            fan_in = n // shape[0]
            out[name] = (flat[off:off + n].view(shape) / math.sqrt(fan_in)).to(dtype)
            off += n
        elif kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
        else:
            out[name] = torch.full(shape, fill[kind], dtype=dtype, device=device)
    return out


def program(weights: Dict[str, torch.Tensor], config: dict, device):
    """The measured flow entry: a `RAFTFlow` over the weights."""
    from deflicker_torch.flow.engine import RAFTFlow
    from deflicker_torch.models.raft import RAFT

    with torch.device("meta"):
        model = RAFT()
    model.load_state_dict(weights, strict=True, assign=True)
    dtype = getattr(torch, config["raft"]["dtype"])
    return RAFTFlow(model=model, iters=config["raft"]["iters"], dtype=dtype,
                    device=device)


def batches(frames: int, pair_batch: int) -> List[List[int]]:
    """The pairs (their first frames) of each call, in the order
    `preprocess_optical_flow` makes them."""
    ks = list(range(frames - 1))
    return [ks[s:s + pair_batch] for s in range(0, len(ks), pair_batch)]


def stacked(frames: np.ndarray, ks: List[int]):
    """Forward then backward directions of the pairs starting at `ks`."""
    a = np.stack([frames[k] for k in ks] + [frames[k + 1] for k in ks])
    b = np.stack([frames[k + 1] for k in ks] + [frames[k] for k in ks])
    return a, b


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_process: float) -> dict:
    parts = {"start": time.perf_counter() - t_process}
    t = time.perf_counter()
    config, traffic = cell.config, cell.traffic
    dtype = getattr(torch, config["raft"]["dtype"])
    frames = frames_uint_levels(config["clip"], traffic["frames"],
                                config["frame_size"], seed, device).cpu().numpy()
    weights = make_weights(seed, device, dtype)
    engine = program(weights, config, device)
    plan = batches(traffic["frames"], config["raft"]["pair_batch"])
    parts["inputs"], t = time.perf_counter() - t, time.perf_counter()
    for ks in {len(ks): ks for ks in plan}.values():     # every batch shape
        for _ in range(2):
            engine.compute_batch(*stacked(frames, ks))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    parts["warm"] = time.perf_counter() - t

    rng = random.Random(sub_seed(seed, "sample"))
    kept: List[tuple] = []          # reservoir of (index, pairs, flows)
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    deadline = t0 + seconds
    n, pairs, directions = 0, 0, 0
    last = None
    while True:
        ks = plan[n % len(plan)]
        flows = engine.compute_batch(*stacked(frames, ks))
        item = (n, ks, flows)
        if len(kept) < SAMPLED:
            kept.append(item)
        elif rng.random() < SAMPLED / (n + 1):
            kept[rng.randrange(SAMPLED)] = item
        last = item
        n += 1
        pairs += len(ks)
        directions += 2 * len(ks)
        if time.perf_counter() >= deadline:
            break
    t1 = time.perf_counter()
    window = {"seconds": t1 - t0, "pairs": pairs, "directions": directions,
              "batches": n}

    traced = None
    if trace:
        traced = {"batches": [2 * len(ks) for ks in plan]}
        with tracing.profiled(traced):
            for ks in plan:
                with tracing.span("pair_stack"):
                    a, b = stacked(frames, ks)
                with tracing.span("compute_batch"):
                    engine.compute_batch(a, b)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del engine
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference solves the sampled batches again
    model = reference.Model(weights)
    checked = {i: (ks, f) for i, ks, f in kept + [last]}
    gaps, dots, looked = [], 0, 0
    H8, W8 = config["frame_size"][0] // 8, config["frame_size"][1] // 8
    for i, (ks, flows) in sorted(checked.items()):
        a, b = stacked(frames, ks)
        coords: list = []
        want = reference.flow(model, torch.from_numpy(a).to(device),
                              torch.from_numpy(b).to(device),
                              config["raft"]["iters"], trace=coords)
        gaps.append(flow_gap(flows, want.cpu().numpy()))
        dots += sum(raft_counts.needed_dots(c, H8, W8) for c in coords)
        looked += sum(c.shape[0] for c in coords)
    window["dots_per_direction_lookup"] = dots / looked
    return {"e2e": {"flow_pairs_per_s": pairs / window["seconds"]},
            "setup_s": setup_s, "window": window, "trace": traced,
            "checks": {"flow_epe": max(gaps)}, "attempted": n, "failed": 0,
            "memory_peak_bytes": peak, "setup_parts": parts}


def flow_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The worst flow's mean endpoint distance from the reference's, in
    pixels: max over the batch's directions of mean |got - want|_2."""
    d = np.sqrt(((got.astype(np.float64) - want) ** 2).sum(-1))
    return float(d.reshape(d.shape[0], -1).mean(1).max())
