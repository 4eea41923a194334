"""GMA (zacjiang/GMA `core/network.py` `RAFTGMA`, one head, content only) as
the flow cells run it: seeded weights at the published widths, the port's
`RAFTFlow` over them (which solves GMA when its model is one), the plain
reference of `reference/gma.py`, GMA's counts of `counts/gma.py`, and the
faults particular to its update block and attention.  The configuration's
`"gma"` block holds its settings.

Beside `flowmodels.API` it gives the attention layer's yardstick:
`attention_bound_s(directions, H8, W8, iters)` and `ATTENTION_KERNELS`, the
names of the device kernels that compute the attention.

The weights are drawn as RAFT's are (`flowmodels/raft.py`), with three
choices that random weights force, stated in the configuration's
`assumed`: gamma is `GAMMA`, not GMA's initial 0 (at 0 the attention drops
out of the result, and the check could not see it); `to_qk` is drawn
`QK_GAIN` times wider than the other convolutions, so that the attention
over 32,400 positions at 1080p is not near-uniform (it would then average
v over the frame, and rolling the keys would change nothing), each of its
rows less its mean over the 128 input channels: the context features
come out of a relu, all positive around a common level, and a free draw
carries that level into every q and k, where the bf16 program rounds it
with the rest; the logits' errors then grow with a level that the softmax
removes, and seed by seed the program's flows strayed from the reference's
by up to half an altered answer's 1 px; and the flow
head's output conv with the nine taps of each (output, input) pair summing
to zero, `HEAD_GAIN` times as wide.  A random head with free taps adds
the same vector at every position each iteration (the mean of its inputs
through its taps' sums), so the random model's flow is a uniform drift
whose size, 2-140 px a frame, varies several times from one seed to the
next, and the bf16 program's distance from the reference grows with it;
with zero-sum taps the head answers only to its features' variation and
the flows are a few pixels on every seed, near the clip's own 4.
"""

from __future__ import annotations

import math
from typing import Dict
from unittest import mock

import torch

from ..core.seeds import sub_seed
from ..counts import gma as counts
from ..data.clips import frames_uint_levels
from ..reference import gma as plain

needed_dots = counts.needed_dots
lookup_bound_s = counts.lookup_bound_s
attention_bound_s = counts.attention_bound_s

# the attention's kernels, as the device trace names them (csrc/gma_attention.cu)
ATTENTION_KERNELS = ("gma_attn_build_kernel", "gma_attn_aggregate_kernel")
GAMMA = 1.0
TOP_WEIGHT = 0.3            # the attention's mean top weight that sets to_qk's gain
CALIBRATION = (1080, 1920)  # the frame it is set on: the configuration's frame size
ROWS = 512                  # the rows it is averaged over
QK_GAIN_MAX = 64.0
HEAD_GAIN = 0.3
QK = "att.to_qk.weight"
HEAD = "update_block.flow_head.conv2.weight"
DRAWN = ("conv_w", "qk_w", "pos_emb")


def settings(config: dict) -> dict:
    return config["gma"]


def make_weights(seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """GMA's state dict at the published widths: conv weights normal with
    std 1/sqrt(fan_in) (to_qk's rows less their mean, then `qk_gain` times
    that; the flow head's output conv with each (output, input) pair's
    taps less their mean, then HEAD_GAIN times that), the position tables
    normal, all from one draw on the device; zero biases, batch norms at
    their initial statistics, gamma GAMMA; in `dtype` (the position index
    as published)."""
    shapes = plain.parameter_shapes()
    total = sum(math.prod(s) for _, s, kind in shapes if kind in DRAWN)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "gma"))
    flat = torch.randn((total,), generator=gen, device=device)
    out, off = {}, 0
    fill = {"conv_b": 0.0, "bn_w": 1.0, "bn_b": 0.0, "bn_mean": 0.0, "bn_var": 1.0,
            "gamma": GAMMA}
    for name, shape, kind in shapes:
        if kind in DRAWN:
            n = math.prod(shape)
            w = flat[off:off + n].view(shape)
            off += n
            if kind != "pos_emb":
                gain = 1.0
                if kind == "qk_w":
                    w = w - w.mean(dim=1, keepdim=True)
                if name == HEAD:
                    w, gain = w - w.mean(dim=(2, 3), keepdim=True), HEAD_GAIN
                w = w * (gain / math.sqrt(n // shape[0]))
            out[name] = w
        elif kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
        elif kind == "pos_index":
            out[name] = plain.position_index().to(device)
        else:
            out[name] = torch.full(shape, fill[kind], device=device)
    out[QK] = out[QK] * qk_gain(out, seed, device)
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in out.items()}


def qk_gain(weights: Dict[str, torch.Tensor], seed: int, device) -> float:
    """The gain of to_qk's draw for this seed: the one at which the
    attention over a `CALIBRATION` frame of the seed's pan texture gives
    `ROWS` of its rows, drawn from the seed, a mean top weight of
    `TOP_WEIGHT`.  `weights` hold to_qk at gain 1, in float32; the top
    weight grows with the gain, which is found by bisection of its log."""
    frame = frames_uint_levels("pan", 1, CALIBRATION, sub_seed(seed, "qk_gain"), device)
    model = plain.Model(weights)
    with torch.no_grad():
        cnet = model.encoder(2 * (frame.permute(0, 3, 1, 2) / 255.0) - 1, "cnet", True)
        qk = model.conv(torch.relu(cnet[:, plain.HIDDEN:]), "att.to_qk")[0]
        qk = qk.reshape(qk.shape[0], -1)
        q, k = qk[:plain.DIM_HEAD], qk[plain.DIM_HEAD:]
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "qk_rows"))
        rows = torch.randperm(q.shape[1], generator=gen, device=device)[:ROWS]
        x = torch.matmul(q[:, rows].T, k) * plain.DIM_HEAD ** -0.5
        lo, hi = 0.0, math.log(QK_GAIN_MAX)
        for _ in range(30):
            mid = (lo + hi) / 2
            top = torch.softmax(x * math.exp(2 * mid), dim=-1).amax(-1).mean()
            lo, hi = (mid, hi) if float(top) < TOP_WEIGHT else (lo, mid)
    return math.exp((lo + hi) / 2)


def program(weights: Dict[str, torch.Tensor], config: dict, device):
    """The measured flow entry: a `RAFTFlow` over a GMA holding the weights."""
    from deflicker_torch.flow.engine import RAFTFlow
    from deflicker_torch.models.gma import GMA

    with torch.device("meta"):
        model = GMA()
    model.load_state_dict(weights, strict=True, assign=True)
    gma = settings(config)
    return RAFTFlow(model=model, iters=gma["iters"],
                    dtype=getattr(torch, gma["dtype"]), device=device)


def reference(weights: Dict[str, torch.Tensor], precision: str = "f32") -> plain.Model:
    return plain.Model(weights, precision)


def reference_flow(model: plain.Model, image1: torch.Tensor, image2: torch.Tensor,
                   config: dict, trace=None) -> torch.Tensor:
    return plain.flow(model, image1, image2, settings(config)["iters"], trace=trace)


def direction_flops(config: dict) -> float:
    H, W = config["frame_size"]
    return counts.direction_flops(H, W, settings(config)["iters"])


def state_unchanged():
    """The GRU step returns its state and no flow update."""
    from deflicker_torch.models import gma

    def frozen(self, net, inp, corr, flow, attention):
        return net, torch.zeros_like(flow)
    return mock.patch.object(gma.GMAUpdateBlock, "forward", frozen)


def aggregate_dropped():
    """The aggregation returns the motion features: g = mf."""
    from deflicker_torch.models import gma

    return mock.patch.object(gma.Aggregate, "forward", lambda self, attn, fmap: fmap)


def keys_rolled():
    """The keys rolled by one row of positions before the softmax: the
    attention's pattern moves, its mean does not."""
    from deflicker_torch.models import gma

    qk = gma.Attention.qk

    def rolled(self, inp):
        x = qk(self, inp)
        q, k = x[..., :plain.DIM_HEAD], x[..., plain.DIM_HEAD:]
        return torch.cat([q, torch.roll(k, shifts=1, dims=1)], dim=-1)
    return mock.patch.object(gma.Attention, "qk", rolled)


def faults() -> dict:
    return {"state_unchanged": state_unchanged, "aggregate_dropped": aggregate_dropped,
            "keys_rolled": keys_rolled}
