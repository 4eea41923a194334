"""Stage-1 atlas losses as static-shape functions on tensors.

The reference (src/models/stage_1/loss_utils.py) selects dynamic-size
subsets of the batch for the flow losses; as in the JAX package these
reduce with multiply-by-mask, normalized by the mask population — the same
mean over the same samples.  The engine evaluates all coordinate variants in
one fused forward per network; these functions consume the per-sample
results.  Every loss reduces over the sample axis (the last one left after
the channel sums) only, so inputs with a leading video axis give one loss
per video.
"""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a finite gradient at 0: sqrt(max(ss, 1e-24)).  The
    masked formulation evaluates the norm at samples the reference filters
    out (zero flow, colliding uv), where a plain norm's 0/0 gradient would
    poison the masked mean with NaN."""
    ss = torch.sum(x * x, dim=dim)
    return torch.sqrt(torch.clamp(ss, min=1e-24))


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(values * mask) / sum(mask) over the sample axis, 0 when the mask
    is empty."""
    mask = mask.to(values.dtype)
    denom = mask.sum(-1)
    return torch.where(denom > 0,
                       (values * mask).sum(-1) / denom.clamp(min=1.0),
                       torch.zeros_like(denom))


def rgb_loss(rgb_pred: torch.Tensor, rgb_gt: torch.Tensor) -> torch.Tensor:
    """mean ||pred - gt||^2 over the batch (src/stage1_neural_atlas.py:194)."""
    return torch.mean(torch.sum((rgb_pred - rgb_gt) ** 2, dim=-1), dim=-1)


def gradient_loss(rgb_pred, rgb_xplus1, rgb_yplus1, dx_gt, dy_gt):
    """Finite-difference color-gradient matching (paper Eq. 7;
    loss_utils.py:134-170)."""
    ex = torch.sum((dx_gt - (rgb_xplus1 - rgb_pred)) ** 2, dim=-1)
    ey = torch.sum((dy_gt - (rgb_yplus1 - rgb_pred)) ** 2, dim=-1)
    return torch.mean(ex + ey, dim=-1)


def rigidity_loss(uv, uv_yminus, uv_xminus, derivative_amount: float,
                  larger_dim: int, uv_mapping_scale: float = 1.0,
                  reduce: bool = True) -> torch.Tensor:
    """Jacobian rigidity loss (paper Eq. 9; loss_utils.py:227-278):
    ||JᵀJ||_F + ||(JᵀJ)⁻¹||_F with the reference's (a+1e-3, d+1e-3)
    regularization, plus two floors the reference lacks: a sign-preserving
    |det| >= 1e-12 and sqrt(max(., 1e-24)).  Without them a degenerate
    Jacobian turns the whole fit NaN."""
    scale = (larger_dim / 2.0) / (uv_mapping_scale * derivative_amount)
    du_dx = (uv[..., 0] - uv_xminus[..., 0]) * scale
    du_dy = (uv[..., 0] - uv_yminus[..., 0]) * scale
    dv_dx = (uv[..., 1] - uv_xminus[..., 1]) * scale
    dv_dy = (uv[..., 1] - uv_yminus[..., 1]) * scale

    a = du_dx * du_dx + dv_dx * dv_dx
    b = du_dx * du_dy + dv_dx * dv_dy
    c = b
    d = du_dy * du_dy + dv_dy * dv_dy

    ar = a + 0.001
    dr = d + 0.001
    det = ar * dr - b * c
    det = torch.where(det >= 0, torch.clamp(det, min=1e-12),
                      torch.clamp(det, max=-1e-12))
    inv_a = dr / det
    inv_b = -b / det
    inv_c = -c / det
    inv_d = ar / det

    norm_jtj = torch.sqrt(torch.clamp(a * a + b * b + c * c + d * d, min=1e-24))
    norm_inv = torch.sqrt(torch.clamp(
        inv_a ** 2 + inv_b ** 2 + inv_c ** 2 + inv_d ** 2, min=1e-24))
    per_sample = norm_jtj + norm_inv
    return torch.mean(per_sample, dim=-1) if reduce else per_sample


def flow_loss(uv, uv_match_fwd, uv_match_bwd, mask_fwd, mask_bwd,
              larger_dim: int, uv_mapping_scale: float, alpha=1.0):
    """Optical-flow consistency loss (paper Eq. 11; loss_utils.py:299-322),
    level 0 only (the only level the reference's pipeline reaches).  alpha
    weights each sample; 1.0 on the single-atlas path."""
    scale = larger_dim / (2.0 * uv_mapping_scale)
    err_fwd = safe_norm(uv_match_fwd - uv) * scale
    err_bwd = safe_norm(uv_match_bwd - uv) * scale
    if not isinstance(alpha, torch.Tensor):
        a = alpha
    elif alpha.dim() == err_fwd.dim() + 1:
        a = alpha.squeeze(-1)
    else:
        a = alpha
    return (0.5 * masked_mean(err_bwd * a, mask_bwd)
            + 0.5 * masked_mean(err_fwd * a, mask_fwd))


def _squeeze_to(v: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return v.squeeze(-1) if v.dim() == ref.dim() + 1 else v


def sparsity_loss(rgb_fg: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """mean ||rgb_fg * (1 - alpha)||^2 (src/stage1_neural_atlas_seg.py:244-248)."""
    return torch.mean(torch.sum((rgb_fg * (1.0 - alpha)) ** 2, dim=-1), dim=-1)


def alpha_bootstrap_loss(alpha: torch.Tensor, mask_gt: torch.Tensor
                         ) -> torch.Tensor:
    """BCE between squashed alpha and the segmentation mask
    (src/stage1_neural_atlas_seg.py:301-302)."""
    alpha = _squeeze_to(alpha, mask_gt)
    return torch.mean(-mask_gt * torch.log(alpha)
                      - (1.0 - mask_gt) * torch.log(1.0 - alpha), dim=-1)


def alpha_flow_loss(alpha, alpha_match_fwd, alpha_match_bwd,
                    mask_fwd, mask_bwd) -> torch.Tensor:
    """L1 alpha consistency along flow (paper Eq. 12; loss_utils.py:385-408)."""
    a = _squeeze_to(alpha, mask_fwd)
    af = _squeeze_to(alpha_match_fwd, mask_fwd)
    ab = _squeeze_to(alpha_match_bwd, mask_fwd)
    return 0.5 * (masked_mean(torch.abs(a - af), mask_fwd)
                  + masked_mean(torch.abs(ab - a), mask_bwd))
