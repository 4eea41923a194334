"""Stage-1 renderer / evaluator.

Renders every frame from the fitted atlas — the input of stage 2 — and
writes the reference's artifact set (src/models/stage_1/evaluate.py:616-793):
`results/<vid>/stage_1/output/%05d.png`, per-frame PSNR, a `PSNR_<mean>`
marker file, `reconstruction.mp4` and a checkpoint.

The render uses the plain fp32 `imlp_apply`, as the JAX package renders at
HIGHEST precision: matrix products outside any kernel, so `torch.matmul`
(with TF32 off, see utils.device.set_fp32_matmul_precision).  The render
diagnostics (`render_diagnostics`, `save_diagnostic_videos`) are a later
slice of the port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import AtlasConfig
from ..metrics import psnr
from ..models.imlp import imlp_apply
from ..ops.coords import normalize_xyt
from ..utils.checkpoint import save_checkpoint
from .data import VideoData
from .engine import AtlasSpecs, Params


@torch.no_grad()
def render_frames(params: Params, specs: AtlasSpecs, T: int, H: int, W: int,
                  rows_per_call: int = 1 << 19) -> np.ndarray:
    """All frames -> (T, H, W, 3) float32 on the host, rendered on the
    params' device a few whole frames (<= rows_per_call pixels) at a time."""
    device = params["mapping1"][0]["w"].device
    L = max(H, W)
    ii, jj = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    jj, ii = jj.reshape(-1), ii.reshape(-1)
    n_fr = max(1, rows_per_call // (H * W))
    out = np.zeros((T, H, W, 3), np.float32)
    for f0 in range(0, T, n_fr):
        fs = torch.arange(f0, min(T, f0 + n_fr), device=device)
        k = fs.numel()
        xyt = normalize_xyt(jj.repeat(k), ii.repeat(k),
                            fs.repeat_interleave(H * W), L, T)
        uv1 = imlp_apply(params["mapping1"], xyt, specs.mapping1)
        rgb = (imlp_apply(params["atlas"], uv1 * 0.5 + 0.5, specs.atlas)
               + 1.0) * 0.5
        out[f0:f0 + k] = rgb.reshape(k, H, W, 3).cpu().numpy()
    return out


def save_mask_flow_videos(data: VideoData, results_folder: str | Path,
                          fps: int = 10) -> None:
    """Diagnostic videos: input video + forward-flow consistency mask
    overlay (masked-out pixels painted red), the reference's
    `save_mask_flow` (src/models/stage_1/unwrap_utils.py:200-231)."""
    import cv2

    results_folder = Path(results_folder)
    results_folder.mkdir(parents=True, exist_ok=True)
    video = np.asarray(data.video)
    mfwd = np.asarray(data.mask_fwd)
    T, H, W, _ = video.shape

    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    w_in = cv2.VideoWriter(str(results_folder / "input_video.mp4"),
                           fourcc, fps, (W, H))
    w_mask = cv2.VideoWriter(str(results_folder / "filter_flow_0.mp4"),
                             fourcc, fps, (W, H))
    for t in range(T):
        frame = video[t].copy()
        if mfwd[t].any():
            bad = mfwd[t] == 0
            frame[bad] = [1.0, 0.0, 0.0]
            w_mask.write((frame[..., ::-1] * 255).astype(np.uint8))
        w_in.write((video[t][..., ::-1] * 255).astype(np.uint8))
    w_in.release()
    w_mask.release()


def evaluate_and_save(params: Params, specs: AtlasSpecs, data: VideoData,
                      cfg: AtlasConfig, results_folder: str | Path,
                      iteration: int, opt_state: Optional[dict] = None
                      ) -> Tuple[np.ndarray, float]:
    """Render, write the output PNGs, the PSNR marker, the mp4 and the
    checkpoint.  Returns (rendered (T, H, W, 3), mean PSNR)."""
    from ..io.media import frames_to_video, write_image

    if cfg.save_diagnostics:
        raise NotImplementedError("save_diagnostics: the render diagnostics "
                                  "are a later slice of the port")
    results_folder = Path(results_folder)
    out_dir = results_folder / "output"
    out_dir.mkdir(parents=True, exist_ok=True)

    T, (H, W) = data.num_frames, data.res
    video_np = np.asarray(data.video)
    rendered = render_frames(params, specs, T, H, W)
    psnrs = np.zeros(T)
    for f in range(T):
        write_image(rendered[f], out_dir / f"{f:05d}.png")
        psnrs[f] = psnr(video_np[f], rendered[f], data_range=1.0)

    mean_psnr = float(psnrs.mean())
    # PSNR marker file, like the reference's `PSNR_<val>` (evaluate.py:782-783)
    (results_folder / f"PSNR_{mean_psnr:.2f}").touch()
    frames_to_video(out_dir, results_folder / "reconstruction.mp4", fps=10)
    save_checkpoint(results_folder / "checkpoint", {
        "params": params,
        "opt_state": opt_state,
        "iteration": iteration,
        "dual": False,
    })
    return rendered, mean_psnr
