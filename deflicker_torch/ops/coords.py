"""Coordinate helpers for the atlas fit."""

from __future__ import annotations

import torch


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
