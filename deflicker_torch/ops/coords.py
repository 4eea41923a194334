"""Coordinate helpers: the atlas fit's normalized cube, pixel grids."""

from __future__ import annotations

import torch


def coords_grid(h: int, w: int, dtype=torch.float32, device=None
                ) -> torch.Tensor:
    """(h, w, 2) grid of (x, y) pixel coordinates: the reference's
    `coords_grid` content (x first, then y;
    src/models/stage_1/core/utils/utils.py:74-77) in HWC layout."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def normalize_xyt(j, i, f, larger_dim: int, num_frames: int) -> torch.Tensor:
    """Map integer pixel/frame indices to the [-1, 1] coordinate cube.

    x = j/(L/2) - 1,  y = i/(L/2) - 1,  t = f/(T/2) - 1, with L the larger
    spatial dim — the reference normalization
    (src/stage1_neural_atlas.py:168-171).  Tensors of any (equal) shape;
    returns an (..., 3) float32 tensor.
    """
    j = torch.as_tensor(j).float()
    i = torch.as_tensor(i).float()
    f = torch.as_tensor(f).float()
    x = j / (larger_dim / 2.0) - 1.0
    y = i / (larger_dim / 2.0) - 1.0
    t = f / (num_frames / 2.0) - 1.0
    return torch.stack([x, y, t], dim=-1)
