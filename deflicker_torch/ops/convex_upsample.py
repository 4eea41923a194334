"""Resize ops shared with stage 2.  RAFT's `convex_upsample_flow` and
`upflow8` belong to the RAFT slice and are not ported yet."""

from __future__ import annotations

import torch


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int
                                  ) -> torch.Tensor:
    """align_corners=True bilinear resize of (N, H, W, C), sampled
    explicitly as in the JAX package (same weights, same order of ops)."""
    N, H, W, C = x.shape
    dev = x.device
    ys = torch.linspace(0.0, H - 1.0, out_h, device=dev)
    xs = torch.linspace(0.0, W - 1.0, out_w, device=dev)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    # f32 weights: a bf16 input promotes to f32 here, as jnp does
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]

    def g(iy, ix):
        return x[:, iy][:, :, ix]

    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy
