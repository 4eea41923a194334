"""Stage-1 renderer / evaluator.

Renders every frame from the fitted atlas — the input of stage 2 — and
writes the reference's artifact set (src/models/stage_1/evaluate.py:616-793
single / :203-602 dual): `results/<vid>/stage_1/output/%05d.png`, per-frame
PSNR, a `PSNR_<mean>` marker file, `reconstruction.mp4` and a checkpoint;
with `AtlasConfig.save_diagnostics` also the residual / uv / per-pixel-loss
videos (and the alpha set on the dual path).

The render uses the plain fp32 `imlp_apply`, as the JAX package renders at
HIGHEST precision: matrix products outside any kernel, so `torch.matmul`
(with TF32 off, see utils.device.set_fp32_matmul_precision).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import AtlasConfig
from ..metrics import psnr
from ..models.imlp import imlp_apply
from ..ops.coords import normalize_xyt
from ..utils.checkpoint import save_checkpoint
from .data import VideoData
from .engine import AtlasSpecs, Params, squash_alpha


def param_device(params: Params) -> torch.device:
    return params["mapping1"][0]["w"].device


def _pixel_grid(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(j, i) of every pixel, row-major."""
    ii, jj = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    return jj.reshape(-1), ii.reshape(-1)


def _render_xyt(params: Params, specs: AtlasSpecs, xyt: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """The fitted models at normalized coordinates xyt (N, 3):
    {'rgb' (N, 3), 'uv1' (N, 2)[, 'alpha' (N, 1), 'uv2' (N, 2)]} — on the
    dual path rgb is the alpha blend of the fg and bg atlas quadrants
    (evaluate.py:729-733)."""
    uv1 = imlp_apply(params["mapping1"], xyt, specs.mapping1)
    rgb = (imlp_apply(params["atlas"], uv1 * 0.5 + 0.5, specs.atlas)
           + 1.0) * 0.5
    out = {"uv1": uv1}
    if specs.dual:
        uv2 = imlp_apply(params["mapping2"], xyt, specs.mapping2)
        rgb2 = (imlp_apply(params["atlas"], uv2 * 0.5 - 0.5, specs.atlas)
                + 1.0) * 0.5
        a = squash_alpha(imlp_apply(params["alpha"], xyt, specs.alpha))
        rgb = rgb * a + rgb2 * (1.0 - a)
        out["alpha"] = a
        out["uv2"] = uv2
    out["rgb"] = rgb
    return out


@torch.no_grad()
def render_frame(params: Params, specs: AtlasSpecs, f: int, H: int, W: int,
                 T: int) -> Dict[str, torch.Tensor]:
    """One frame (all H*W pixels) from the fitted models, on the params'
    device: {'rgb': (H, W, 3), 'uv1': (H, W, 2)[, 'alpha': (H, W, 1),
    'uv2': (H, W, 2)]}."""
    device = param_device(params)
    j, i = _pixel_grid(H, W, device)
    xyt = normalize_xyt(j, i, torch.full((H * W,), f, device=device),
                        max(H, W), T)
    return {k: v.reshape(H, W, -1)
            for k, v in _render_xyt(params, specs, xyt).items()}


@torch.no_grad()
def render_frames(params: Params, specs: AtlasSpecs, T: int, H: int, W: int,
                  rows_per_call: int = 1 << 19) -> np.ndarray:
    """All frames -> (T, H, W, 3) float32 on the host, rendered on the
    params' device a few whole frames (<= rows_per_call pixels) at a time."""
    device = param_device(params)
    jj, ii = _pixel_grid(H, W, device)
    n_fr = max(1, rows_per_call // (H * W))
    out = np.zeros((T, H, W, 3), np.float32)
    for f0 in range(0, T, n_fr):
        fs = torch.arange(f0, min(T, f0 + n_fr), device=device)
        k = fs.numel()
        xyt = normalize_xyt(jj.repeat(k), ii.repeat(k),
                            fs.repeat_interleave(H * W), max(H, W), T)
        rgb = _render_xyt(params, specs, xyt)["rgb"]
        out[f0:f0 + k] = rgb.reshape(k, H, W, 3).cpu().numpy()
    return out


@torch.no_grad()
def render_diagnostics(params: Params, specs: AtlasSpecs, data: VideoData,
                       f: int, cfg: AtlasConfig) -> Dict[str, torch.Tensor]:
    """Per-pixel diagnostic maps for one frame: reconstruction, residual,
    rigidity loss, flow loss — the reference's `_all` loss visualizations
    (loss_utils.py:283-295,360-382; evaluate.py:672-712)."""
    from ..losses import rigidity_loss, safe_norm

    device = param_device(params)
    T, (H, W) = data.num_frames, data.res
    L = data.larger_dim
    d = cfg.derivative_amount
    j, i = _pixel_grid(H, W, device)
    ff = torch.full((H * W,), f, device=device)
    ffwd = torch.as_tensor(np.asarray(data.flow_fwd[f]), device=device
                           ).reshape(H * W, 2)
    mfwd = torch.as_tensor(np.asarray(data.mask_fwd[f]), device=device
                           ).reshape(H * W).float()

    def uv_at(jx, iy, fz):
        return imlp_apply(params["mapping1"],
                          normalize_xyt(jx, iy, fz, L, T), specs.mapping1)

    base = _render_xyt(params, specs, normalize_xyt(j, i, ff, L, T))
    uv, rgb = base["uv1"], base["rgb"]
    uv_ym = uv_at(j, i - d, ff)
    uv_xm = uv_at(j - d, i, ff)
    uv_fwd = uv_at(j + ffwd[:, 0], i + ffwd[:, 1], ff.float() + 1.0)

    rig = rigidity_loss(uv, uv_ym, uv_xm, d, L, cfg.uv_mapping_scale,
                        reduce=False)
    flow_err = (safe_norm(uv_fwd - uv) * L / (2.0 * cfg.uv_mapping_scale)
                * mfwd)
    gt = torch.as_tensor(np.asarray(data.video[f]), device=device
                         ).reshape(H * W, 3)
    out = {
        "rgb": rgb.reshape(H, W, 3),
        "residual": (gt - rgb).reshape(H, W, 3),
        "uv1": uv.reshape(H, W, 2),
        "rigidity_map": rig.reshape(H, W),
        "flow_map": flow_err.reshape(H, W),
        "rgb_error_map": torch.sum((gt - rgb) ** 2, dim=-1).reshape(H, W),
    }
    if specs.dual:
        out["uv2"] = base["uv2"].reshape(H, W, 2)
        out["alpha"] = base["alpha"].reshape(H, W)
    return out


def _global_info_panel(diag: Dict[str, np.ndarray],
                       original: np.ndarray) -> np.ndarray:
    """One matplotlib "global info" frame: reconstruction / original / RGB
    error / flow loss / rigidity loss in the reference's subplot layout and
    value ranges (evaluate.py:745-773)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(20, 10))
    for pos, img, title, lim in (
            (1, np.clip(diag["rgb"], 0, 1), "video_reconstruction", (0.0, 1.0)),
            (2, original, "original_video", (0.0, 1.0)),
            (3, diag["rgb_error_map"], "RGB error", (0.0, 0.2)),
            (9, diag["flow_map"], "flow_loss1", (0.0, 2.0)),
            (12, diag["rigidity_map"], "rigidity_loss1", (2.8, 50.0))):
        plt.subplot(3, 4, pos)
        plt.imshow(img, vmin=lim[0], vmax=lim[1])
        plt.colorbar()
        plt.title(title)
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def save_diagnostic_videos(params: Params, specs: AtlasSpecs,
                           data: VideoData, cfg: AtlasConfig,
                           results_folder: str | Path, fps: int = 10,
                           global_info: bool = True) -> None:
    """residuals / uv / per-pixel-loss mp4s (the reference evaluator's
    visualization set, evaluate.py:729-773 single path), plus for the dual
    path: alpha, alpha-vs-mask, uv_2 and masked-uv_1 videos
    (evaluate.py:503-583), and the matplotlib `global_info.mp4` panels."""
    import cv2

    results_folder = Path(results_folder)
    results_folder.mkdir(parents=True, exist_ok=True)
    T, (H, W) = data.num_frames, data.res

    def bgr8(img):
        return (img[..., ::-1] * 255).astype(np.uint8)

    names = ["residuals", "uv_1", "rigidity_loss", "flow_loss", "rgb_error"]
    if specs.dual:
        names += ["alpha", "alpha_vs_mask", "uv_2", "uv_1_masked"]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writers = {name: cv2.VideoWriter(str(results_folder / f"{name}.mp4"),
                                     fourcc, fps, (W, H))
               for name in names}
    w_info = None
    try:
        for f in range(T):
            diag = {k: v.cpu().numpy() for k, v in
                    render_diagnostics(params, specs, data, f, cfg).items()}
            writers["residuals"].write(
                bgr8(np.clip(diag["residual"] + 0.5, 0, 1)))
            # uv in [-1,1] -> [0,1] (normalize_uv_images with edge 1)
            uv_img = np.zeros((H, W, 3), np.float32)
            uv_img[..., :2] = np.clip(diag["uv1"] * 0.5 + 0.5, 0, 1)
            writers["uv_1"].write(bgr8(uv_img))
            for name, key in (("rigidity_loss", "rigidity_map"),
                              ("flow_loss", "flow_map"),
                              ("rgb_error", "rgb_error_map")):
                m = diag[key]
                m = m / max(float(m.max()), 1e-6)
                writers[name].write(
                    (np.stack([m] * 3, -1) * 255).astype(np.uint8))
            if specs.dual:
                a = np.clip(diag["alpha"], 0, 1)
                writers["alpha"].write(bgr8(np.stack([a] * 3, -1)))
                # red = provided mask, green = learned alpha
                # (alpha_vs_mask_rcnn, evaluate.py:552-557)
                avm = np.stack([np.asarray(data.mask[f]), a,
                                np.zeros_like(a)], axis=-1)
                writers["alpha_vs_mask"].write(bgr8(avm))
                uv2_img = np.zeros((H, W, 3), np.float32)
                uv2_img[..., :2] = np.clip(diag["uv2"] * 0.5 + 0.5, 0, 1)
                writers["uv_2"].write(bgr8(uv2_img))
                writers["uv_1_masked"].write(bgr8(uv_img * a[..., None]))
            if global_info:
                panel = _global_info_panel(diag, np.asarray(data.video[f]))
                if w_info is None:
                    ph, pw = panel.shape[:2]
                    w_info = cv2.VideoWriter(
                        str(results_folder / "global_info.mp4"), fourcc,
                        fps, (pw, ph))
                w_info.write(panel[..., ::-1])
    finally:
        for w in writers.values():
            w.release()
        if w_info is not None:
            w_info.release()


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
                      iteration: int, opt_state: Optional[dict] = None,
                      save_video: bool = True, save_ckpt: bool = True,
                      frame_offset: int = 0, first_saved_frame: int = 0,
                      psnr_marker: bool = True) -> Tuple[np.ndarray, float]:
    """Render, write the output PNGs, the PSNR marker, the mp4 and the
    checkpoint.  Returns (rendered (T, H, W, 3), mean PSNR).

    `frame_offset` / `first_saved_frame` serve the chunked long-video path:
    frame f of `data` saves as `%05d % (f + frame_offset)`, frames below
    `first_saved_frame` are rendered but not written (the last chunk's
    overlap, already written by the chunk before it), and the PSNR averages
    the written frames only.  `save_video`, `save_ckpt` and `psnr_marker`
    turn off the mp4, the checkpoint and the marker file (the chunked path
    writes them once for the whole video)."""
    from ..io.media import frames_to_video, write_image

    results_folder = Path(results_folder)
    out_dir = results_folder / "output"
    out_dir.mkdir(parents=True, exist_ok=True)

    T, (H, W) = data.num_frames, data.res
    video_np = np.asarray(data.video)
    rendered = render_frames(params, specs, T, H, W)
    psnrs = np.zeros(T - first_saved_frame)
    for f in range(first_saved_frame, T):
        write_image(rendered[f], out_dir / f"{f + frame_offset:05d}.png")
        psnrs[f - first_saved_frame] = psnr(video_np[f], rendered[f],
                                            data_range=1.0)

    mean_psnr = float(psnrs.mean())
    # PSNR marker file, like the reference's `PSNR_<val>` (evaluate.py:782-783)
    if psnr_marker:
        (results_folder / f"PSNR_{mean_psnr:.2f}").touch()
    if save_video:
        frames_to_video(out_dir, results_folder / "reconstruction.mp4", fps=10)
    if cfg.save_diagnostics:
        save_diagnostic_videos(params, specs, data, cfg, results_folder)
    if save_ckpt:
        save_checkpoint(results_folder / "checkpoint", {
            "params": params,
            "opt_state": opt_state,
            "iteration": iteration,
            "dual": specs.dual,
        })
    return rendered, mean_psnr
