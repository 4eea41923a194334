"""RAFT (princeton-vl/RAFT `core/raft.py`, raft-things) as the flow cells
run it: seeded weights at the published widths, the port's `RAFTFlow` over
them, the plain reference of `reference/raft.py`, RAFT's counts of
`counts/raft.py`, and the fault particular to its update block.  The
configuration's `"raft"` block holds its settings."""

from __future__ import annotations

import math
from typing import Dict
from unittest import mock

import torch

from ..core.seeds import sub_seed
from ..counts import raft as counts
from ..reference import raft as plain

needed_dots = counts.needed_dots
lookup_bound_s = counts.lookup_bound_s


def settings(config: dict) -> dict:
    return config["raft"]


def make_weights(seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """RAFT's state dict at the published widths: conv weights normal with
    std 1/sqrt(fan_in) from one draw on the device, zero biases, batch norms
    at their initial statistics; in `dtype`."""
    shapes = plain.parameter_shapes()
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
    raft = settings(config)
    return RAFTFlow(model=model, iters=raft["iters"],
                    dtype=getattr(torch, raft["dtype"]), device=device)


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
    from deflicker_torch.models import raft

    def frozen(self, net, inp, corr, flow):
        return net, torch.zeros_like(flow)
    return mock.patch.object(raft.BasicUpdateBlock, "forward", frozen)


def faults() -> dict:
    return {"state_unchanged": state_unchanged}
