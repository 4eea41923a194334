"""Forward/backward flow consistency masks and flow resizing (the
reference's src/models/stage_1/unwrap_utils.py:10-38 recipe): a pixel of the
forward flow is consistent when ||flow12(p) + flow21(p + flow12(p))|| < 1."""

from __future__ import annotations

import numpy as np
import torch

from .sampling import flow_warp


def compute_consistency(flow12: torch.Tensor, flow21: torch.Tensor
                        ) -> torch.Tensor:
    """(H, W) forward-backward error of flow12 given flow21, both (H, W, 2)."""
    diff = flow12 + flow_warp(flow21, flow12)
    return torch.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2)


def consistency_masks(flow12: torch.Tensor, flow21: torch.Tensor,
                      threshold: float = 1.0):
    """(mask_fwd, mask_bwd) boolean consistency masks for a flow pair."""
    m12 = compute_consistency(flow12, flow21) < threshold
    m21 = compute_consistency(flow21, flow12) < threshold
    return m12, m21


def resize_flow(flow: np.ndarray, newh: int, neww: int) -> np.ndarray:
    """Resize a flow field (host, cv2 bilinear) and scale each displacement
    axis by its own size ratio (the reference swaps the ratios, which is
    invisible for the uniform downscales the pipeline makes)."""
    import cv2

    oldh, oldw = flow.shape[:2]
    out = cv2.resize(flow, (neww, newh), interpolation=cv2.INTER_LINEAR).copy()
    out[:, :, 0] *= neww / oldw
    out[:, :, 1] *= newh / oldh
    return out
