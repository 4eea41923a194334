"""RAFT's mask-weighted convex flow upsampling, and the align-corners
resize shared with stage 2 (NHWC)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def convex_upsample_flow(flow: torch.Tensor, mask: torch.Tensor,
                         factor: int = 8) -> torch.Tensor:
    """Upsample (N, H, W, 2) flow by `factor`: each fine pixel is a
    softmax-weighted combination of the 3x3 coarse neighbourhood of its
    parent cell (reference: src/models/stage_1/core/raft.py:76-87).

    mask: (N, H, W, 9 * factor * factor) logits laid out as (9, factor,
    factor) per coarse cell; the 9 neighbours run row-major over (dy, dx),
    zero-padded at the border, as `F.unfold` orders them."""
    N, H, W, _ = flow.shape
    r = factor
    m = torch.softmax(mask.reshape(N, H, W, 9, r, r), dim=3)
    padded = F.pad(flow * factor, (0, 0, 1, 1, 1, 1))
    nb = torch.stack([padded[:, dy:dy + H, dx:dx + W, :]
                      for dy in (0, 1, 2) for dx in (0, 1, 2)], dim=3)
    up = torch.einsum("nhwkab,nhwkc->nhwabc", m, nb)     # (N, H, W, r, r, 2)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(N, H * r, W * r, 2)


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
