"""Bilinear sampling primitives (NHWC, pixel coordinates).

The reference's `grid_sample(align_corners=True, padding_mode='zeros')`
wrapper and its flow-warp helper, in pixel coordinates and HWC layout as in
the JAX package: out-of-bounds reads contribute zeros.
"""

from __future__ import annotations

import torch

from .coords import coords_grid


def _gather_2d(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor
               ) -> torch.Tensor:
    """img[iy, ix] with zeros outside; img (H, W, C), iy/ix integer (S...)."""
    H, W = img.shape[0], img.shape[1]
    valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    iyc = iy.clamp(0, H - 1)
    ixc = ix.clamp(0, W - 1)
    flat = img.reshape(H * W, -1)
    vals = flat[(iyc * W + ixc).reshape(-1)].reshape(*iy.shape, flat.shape[1])
    return torch.where(valid[..., None], vals, torch.zeros_like(vals))


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample `img` (H, W, C) at pixel `coords` (..., 2) = (x, y):
    a sample at integer (x, y) returns img[y, x]; out-of-bounds corners
    contribute zero."""
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    v00 = _gather_2d(img, y0i, x0i)
    v01 = _gather_2d(img, y0i, x0i + 1)
    v10 = _gather_2d(img, y0i + 1, x0i)
    v11 = _gather_2d(img, y0i + 1, x0i + 1)
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp `img` (H, W, C) by `flow` (H, W, 2):
    output(p) = img(p + flow(p)), bilinear, zeros outside."""
    H, W = img.shape[0], img.shape[1]
    coords = coords_grid(H, W, flow.dtype, flow.device) + flow
    return bilinear_sample(img, coords)
