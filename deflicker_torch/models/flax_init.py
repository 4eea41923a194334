"""Flax's default initialization of `nn.Conv`, for modules built in the
port: `lecun_normal()` kernels (a normal truncated at ±2 σ, its std
sqrt(1 / fan_in) / 0.87962566103423978 so that the truncated draw has
variance 1 / fan_in, fan_in = kh * kw * in) and zero biases.  PyTorch's
default (kaiming-uniform weights, uniform biases) is another distribution,
and a trainer started from it trains something else than the JAX
package's."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_like_flax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every `nn.Conv2d` of `module` in `named_modules()` order
    from `generator` (a CPU generator, so a seed gives the same weights on
    every device)."""
    for _, m in module.named_modules():
        if not isinstance(m, nn.Conv2d):
            continue
        out_ch, in_ch, kh, kw = m.weight.shape
        std = math.sqrt(1.0 / (in_ch * kh * kw)) / _TRUNC_STD
        w = torch.empty(m.weight.shape, dtype=torch.float32)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        m.weight.copy_(w)
        if m.bias is not None:
            m.bias.zero_()
    return module
