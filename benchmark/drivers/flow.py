"""Traffic of kind "flow": the flow of a clip's consecutive pairs, clip
after clip, closed loop, by the flow model the configuration names
(`benchmark/flowmodels/<name>.py`; RAFT where it names none).

The pairs go through the engine's `compute_batch` as the port's
`preprocess_optical_flow` batches them: `pair_batch` pairs a call, forward
and backward directions stacked into one batch, the tail batch shorter.
The frames sit in memory as float32 levels: no image decodes and no `.npy`
writes, which are host I/O.  The window closes at the first batch whose
flows are back on the host past `seconds`.

Set-up makes the clip and the model's weights on the device from the seed
(the published widths, in the dtype the flow is served in), stacks every
batch of the clip once, and solves one full and one tail batch twice, so
that both solves are captured before the window.  The window then holds
the engine's calls alone: the stack is the traffic's making, 64 MB of host
copies a batch whose page faults and bandwidth swing from one process to
the next on a shared host.  Once the window has closed, a sample of the
window's batches drawn from the seed (two, and the last one) is solved
again by the plain reference, one direction at a time, and compared flow
by flow.

Calibration (`benchmark/calibrate.py`): `sound` is a run as above,
`control` the reference one precision below in the program's place, and
`faults` the generic faults of the flow engine and the model's own.

Traffic parameters: "frames" (T).  The configuration gives the clip, the
frame size and the model's settings.
"""

from __future__ import annotations

import random
import time
from typing import List
from unittest import mock

import numpy as np
import torch

from .. import flowmodels
from ..core import trace as tracing
from ..core.seeds import sub_seed
from ..data.clips import frames_uint_levels

SAMPLED = 2            # batches of the window the reference checks, and the last


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


def inputs(cell, seed: int, device):
    """The clip as float32 levels on the host, the model's weights on the
    device in the dtype the flow is served in, and the batches' plan."""
    config, model = cell.config, flowmodels.of(cell.config)
    settings = model.settings(config)
    frames = frames_uint_levels(config["clip"], cell.traffic["frames"],
                                config["frame_size"], seed, device).cpu().numpy()
    weights = model.make_weights(seed, device, getattr(torch, settings["dtype"]))
    return frames, weights, batches(cell.traffic["frames"], settings["pair_batch"])


def solved(model, plain, frames: np.ndarray, ks: List[int], config: dict,
           device, trace=None) -> np.ndarray:
    """The plain reference's flows of the batch of pairs `ks`, solved one
    direction at a time, so that the device holds one direction's all-pairs
    volume and no more."""
    a, b = stacked(frames, ks)
    return np.concatenate([
        model.reference_flow(plain, torch.from_numpy(a[d:d + 1]).to(device),
                             torch.from_numpy(b[d:d + 1]).to(device), config,
                             trace=trace).cpu().numpy()
        for d in range(a.shape[0])])


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_process: float) -> dict:
    parts = {"start": time.perf_counter() - t_process}
    t = time.perf_counter()
    config, model = cell.config, flowmodels.of(cell.config)
    frames, weights, plan = inputs(cell, seed, device)
    engine = model.program(weights, config, device)
    calls = [stacked(frames, ks) for ks in plan]
    parts["inputs"], t = time.perf_counter() - t, time.perf_counter()
    for i in {len(ks): i for i, ks in enumerate(plan)}.values():  # every shape
        for _ in range(2):
            engine.compute_batch(*calls[i])
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
        flows = engine.compute_batch(*calls[n % len(plan)])
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
            for a, b in calls:
                with tracing.span("compute_batch"):
                    engine.compute_batch(a, b)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del engine, calls
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference solves the sampled batches again
    plain = model.reference(weights)
    checked = {i: (ks, f) for i, ks, f in kept + [last]}
    gaps, dots, looked = [], 0, 0
    H8, W8 = config["frame_size"][0] // 8, config["frame_size"][1] // 8
    for i, (ks, flows) in sorted(checked.items()):
        coords: list = []
        gaps.append(flow_gap(flows, solved(model, plain, frames, ks, config,
                                           device, trace=coords)))
        dots += sum(model.needed_dots(c, H8, W8) for c in coords)
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


def sound(cell, seed: int, seconds: float, device):
    """A sound run's readings: set-up, a window of `seconds`, the comparison."""
    out = measure(cell, seed, seconds, False, device, time.perf_counter())
    return out["checks"], {"failed": out["failed"], "e2e": out["e2e"]}


def control(cell, seed: int, device):
    """The control's readings: the reference one precision below the
    configuration's (fp8 products for its bfloat16 ones) in the program's
    place, against the float32 reference, on the first two batches and the
    tail, one direction at a time."""
    config, model = cell.config, flowmodels.of(cell.config)
    frames, weights, plan = inputs(cell, seed, device)
    want, low = model.reference(weights), model.reference(weights, "fp8")
    gaps = [flow_gap(solved(model, low, frames, ks, config, device),
                     solved(model, want, frames, ks, config, device))
            for ks in (plan[0], plan[1], plan[-1])]
    return {"flow_epe": max(gaps)}, {}


def half_batch():
    """A solve runs the first half of its directions and returns zeros for
    the rest."""
    from deflicker_torch.flow.engine import RAFTFlow

    solve = RAFTFlow._solve

    def half(self, x1, x2):
        h = max(1, x1.shape[0] // 2)
        out = solve(self, x1[:h].contiguous(), x2[:h].contiguous())
        rest = torch.zeros((x1.shape[0] - h,) + tuple(out.shape[1:]),
                           dtype=out.dtype, device=out.device)
        return torch.cat([out, rest])
    return mock.patch.object(RAFTFlow, "_solve", half)


def answer_altered():
    """One direction's flow, where it is produced, one pixel off in x."""
    from deflicker_torch.flow.engine import RAFTFlow

    compute_batch = RAFTFlow.compute_batch

    def altered(self, im1, im2):
        flows = compute_batch(self, im1, im2)
        flows[0, ..., 0] += 1.0
        return flows
    return mock.patch.object(RAFTFlow, "compute_batch", altered)


def faults(cell) -> dict:
    """Faults planted under the timed path, name -> context manager factory:
    the flow model's own, then the flow engine's."""
    return {**flowmodels.of(cell.config).faults(), "half_batch": half_batch,
            "answer_altered": answer_altered}
