"""Warp error (E_warp) — the paper's temporal-consistency metric.

  E_warp(t) = mean over non-occluded pixels of || I_t - warp(I_{t+1}; F_fw) ||^2

`fw_flow` maps frame t -> t+1 and `bw_flow` maps t+1 -> t; sampling frame
t+1 at p + fw_flow(p) resamples it onto frame t's grid.  Occlusion combines
the forward-backward check with a motion-boundary mask (the reference's
src/models/utils.py:532-572 recipe, as in the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sampling import flow_warp
from ..utils.device import resolve_device


def _mag(v):
    return v[..., 0] ** 2 + v[..., 1] ** 2


def _occlusion(fw_warped, bw):
    """(..., H, W) float occlusion (1 = occluded) from the warped forward
    flow and the backward flow, both (..., H, W, 2)."""
    mask1 = _mag(fw_warped + bw) > 0.01 * (_mag(fw_warped) + _mag(bw)) + 0.5
    gx = torch.zeros_like(bw)
    gx[..., :, :-1, :] = bw[..., :, :-1, :] - bw[..., :, 1:, :]
    gy = torch.zeros_like(bw)
    gy[..., :-1, :, :] = bw[..., :-1, :, :] - bw[..., 1:, :, :]
    mask2 = (_mag(gx) + _mag(gy)) > 0.01 * _mag(bw) + 0.002
    return torch.logical_or(mask1, mask2).float()


def occlusion_mask(fw_flow: np.ndarray, bw_flow: np.ndarray) -> np.ndarray:
    """Occlusion mask (1 = occluded) for warping frame2 into frame1:
    fw_flow frame1 -> frame2, bw_flow frame2 -> frame1, both (H, W, 2)."""
    fw = torch.as_tensor(np.asarray(fw_flow, np.float32))
    bw = torch.as_tensor(np.asarray(bw_flow, np.float32))
    return _occlusion(flow_warp(fw, bw), bw).numpy()


def warp_error(frame1: np.ndarray, frame2: np.ndarray,
               fw_flow: np.ndarray, bw_flow: np.ndarray) -> float:
    """Occlusion-masked mean squared warp error of one consecutive pair
    (host path, the oracle of `warp_error_video`)."""
    return float(warp_error_video(frame1[None], frame2[None], fw_flow[None],
                                  bw_flow[None], device="cpu")[0])


@torch.no_grad()
def warp_error_video(frames1, frames2, fw_flows, bw_flows,
                     device=None) -> np.ndarray:
    """Per-pair warp errors of stacked consecutive pairs, on `device` (CUDA
    unless the caller names another; raises without CUDA): frames
    (B, H, W, 3) in [0, 1], flows (B, H, W, 2).  Returns (B,) float64."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(device)
    f1, f2, fw, bw = t(frames1), t(frames2), t(fw_flows), t(bw_flows)
    warped = torch.stack([flow_warp(f2[k], fw[k]) for k in range(f1.shape[0])])
    fw_warped = torch.stack([flow_warp(fw[k], bw[k])
                             for k in range(f1.shape[0])])
    noc = 1.0 - _occlusion(fw_warped, bw)
    denom = noc.sum((1, 2))
    diff = ((f1 - warped) ** 2).sum(-1)
    err = torch.where(denom == 0, torch.zeros_like(denom),
                      (diff * noc).sum((1, 2)) / denom.clamp(min=1.0))
    return err.cpu().numpy().astype(np.float64)
