"""End-to-end pipeline: decode -> flow -> atlas fit -> render -> filter.

Stages call each other as functions, and every stage reads and writes the
reference's filesystem artifacts, so each stays independently runnable and
idempotent.  The port runs the single-atlas path on one device, with RAFT
flow when a RAFT checkpoint is on disk; the dual atlas (`--class_name`) and
the chunked long-video fit are later slices and raise NotImplementedError.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..atlas import (build_specs, evaluate_and_save, fit_atlas, init_models,
                     load_video_data, pretrain_mapping, save_mask_flow_videos)
from ..config import AtlasConfig, PipelineConfig, load_atlas_config
from ..flow import FarnebackFlow, RAFTFlow, preprocess_optical_flow
from ..io.media import list_frames, read_image, video_to_frames
from ..utils.checkpoint import load_checkpoint
from ..utils.convert import atlas_params_from_jax
from ..utils.device import resolve_device, set_fp32_matmul_precision
from ..utils.logging import ScalarLogger


def prepare_frames(cfg: PipelineConfig) -> Path:
    """Stage 0: decode the video (or adopt a frame folder) into
    `<root>/<vid>/%05d.png` (reference: test.py:17-29)."""
    root = Path(cfg.root)
    root.mkdir(parents=True, exist_ok=True)
    if cfg.video_name:
        vid = Path(cfg.video_name).stem
        frames_dir = root / vid
        if not list_frames(frames_dir):
            video_to_frames(cfg.video_name, frames_dir, fps=cfg.fps)
    elif cfg.video_frame_folder:
        src = Path(cfg.video_frame_folder)
        vid = src.name
        frames_dir = root / vid
        if not list_frames(frames_dir) and src.resolve() != frames_dir.resolve():
            shutil.copytree(src, frames_dir)
    else:
        raise ValueError("need --video_name or --video_frame_folder")
    if not list_frames(frames_dir):
        raise FileNotFoundError(f"no frames in {frames_dir}")
    return frames_dir


def make_flow_provider(cfg: PipelineConfig, device=None):
    """RAFT on `device` when its checkpoint is on disk (the torch `.pth` or
    the JAX package's converted file), else Farneback on the host."""
    ckpt = Path(cfg.ckpt_raft)
    for candidate in (ckpt, ckpt.with_suffix(".pth")):
        if candidate.exists():
            return RAFTFlow(candidate, device=device)
    print(f"[deflicker_torch] RAFT checkpoint {ckpt} not found — "
          "falling back to Farneback flow (reduced quality)")
    return FarnebackFlow()


def _stage1_resolution(frames_dir: Path, down: Optional[int],
                       dual: bool) -> tuple:
    """Stage-1 working resolution = first frame / down; config resx/resy
    are ignored exactly like the reference (stage1_neural_atlas.py:31-38).
    down=None means the reference scripts' defaults: 1 (seg) / 4 (single)."""
    first = read_image(list_frames(frames_dir)[0])
    resy, resx = first.shape[0], first.shape[1]
    down = down if down is not None else (1 if dual else 4)
    if down:
        resx, resy = int(resx / down), int(resy / down)
    return resy, resx


def _generators(seed: int, device: torch.device):
    """(init, pretrain, fit) generators from one seed.  Init draws on the
    CPU, so a seed gives the same initial weights on every device."""
    init = torch.Generator().manual_seed(seed)
    pre = torch.Generator(device=device).manual_seed(seed + 1)
    fit = torch.Generator(device=device).manual_seed(seed + 2)
    return init, pre, fit


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_stage1(frames_dir: Path, cfg: PipelineConfig,
               atlas_cfg: AtlasConfig, device, dual: bool = False,
               results_root: Optional[Path] = None,
               flow_provider=None) -> Dict:
    """Flow preprocessing + atlas fit + render (src/stage1_neural_atlas.py
    main()), single fit."""
    if dual:
        raise NotImplementedError("the dual-atlas path (--class_name) is a "
                                  "later slice of the port")
    device = torch.device(device)
    t0 = time.time()
    if flow_provider is None:
        flow_provider = make_flow_provider(cfg, device)
    preprocess_optical_flow(frames_dir, flow_provider,
                            max_long_edge=cfg.max_long_edge)
    t_flow = time.time() - t0

    vid = frames_dir.name
    results_root = Path(results_root or cfg.results_root)
    results_folder = results_root / vid / "stage_1"
    results_folder.mkdir(parents=True, exist_ok=True)
    with open(results_folder / "config.json", "w") as f:
        json.dump(atlas_cfg.to_reference_json(), f, indent=4)

    resy, resx = _stage1_resolution(frames_dir, cfg.down, dual)
    T_all = len(list_frames(frames_dir))
    if T_all > atlas_cfg.maximum_number_of_frames:
        raise NotImplementedError(
            f"{T_all} frames > maximum_number_of_frames "
            f"{atlas_cfg.maximum_number_of_frames}: the chunked long-video fit "
            "is a later slice of the port (the video is not truncated)")

    data = load_video_data(frames_dir, resy, resx,
                           atlas_cfg.maximum_number_of_frames)
    T, (H, W) = data.num_frames, data.res
    save_mask_flow_videos(data, results_folder)

    specs = build_specs(atlas_cfg)
    g_init, g_pre, g_fit = _generators(atlas_cfg.seed, device)

    start_iteration = 0
    opt_state = None
    t_pretrain = 0.0          # stays 0 on the resume branch (no pretrain)
    if atlas_cfg.load_checkpoint and atlas_cfg.checkpoint_path:
        ckpt = load_checkpoint(atlas_cfg.checkpoint_path)
        params = atlas_params_from_jax(ckpt["params"], device)
        opt_state = ckpt.get("opt_state")
        start_iteration = int(ckpt["iteration"])
    else:
        params = init_models(specs, g_init, device)
        t1 = time.time()
        if atlas_cfg.pretrain_mapping1:
            pretrain_mapping(params["mapping1"], specs.mapping1, g_pre, T, H, W,
                             atlas_cfg.uv_mapping_scale,
                             atlas_cfg.pretrain_iter_number)
        _sync(device)
        t_pretrain = time.time() - t1

    logger = ScalarLogger(results_folder)

    def eval_cb(iteration, p, opt):
        evaluate_and_save(p, specs, data, atlas_cfg, results_folder,
                          iteration, opt)

    t2 = time.time()
    result = fit_atlas(params, specs, data, atlas_cfg, g_fit,
                       start_iteration=start_iteration, opt_state=opt_state,
                       eval_callback=eval_cb,
                       log_callback=lambda i, rec: logger.log(i, rec))
    _sync(device)
    t_fit = time.time() - t2

    # final render (the reference's eval at iteration iters_num-1 == 10000)
    t3 = time.time()
    rendered, mean_psnr = evaluate_and_save(
        result.params, specs, data, atlas_cfg, results_folder,
        result.iteration - 1, result.opt_state)
    t_render = time.time() - t3
    logger.log_image(result.iteration - 1, "reconstruction", rendered[0])
    logger.log_image(result.iteration - 1, "input", np.asarray(data.video[0]))
    logger.close()

    iters_done = result.iteration - start_iteration
    return {
        "results_folder": results_folder,
        "psnr": mean_psnr,
        "num_frames": T,
        "res": (H, W),
        "iterations": iters_done,
        "t_flow": t_flow,
        "t_pretrain": t_pretrain,
        "t_fit": t_fit,
        "t_render": t_render,
        "iters_per_sec": iters_done / t_fit if t_fit > 0 else 0.0,
    }


def run_stage2(frames_dir: Path, cfg: PipelineConfig, device,
               results_root: Optional[Path] = None,
               style_dir: Optional[Path] = None, engine=None) -> Dict:
    """Neural filter + local refinement (src/neural_filter_and_refinement.py)."""
    from ..filter import load_filter_engine

    device = torch.device(device)
    vid = frames_dir.name
    results_root = Path(results_root or cfg.results_root)
    style_dir = style_dir or results_root / vid / "stage_1" / "output"
    t0 = time.time()
    if engine is None:
        engine = load_filter_engine(cfg.ckpt_filter, cfg.ckpt_local,
                                    device=device,
                                    dtype=getattr(torch, cfg.stage2_dtype),
                                    unpad=cfg.stage2_unpad)
    engine.run(frames_dir, style_dir, results_root / vid, fps=cfg.fps,
               return_output=False)
    _sync(device)
    return {"t_stage2": time.time() - t0,
            "final_dir": results_root / vid / "final" / "output"}


def run_pipeline(cfg: PipelineConfig, atlas_cfg: Optional[AtlasConfig] = None,
                 device=None, flow_provider=None, filter_engine=None) -> Dict:
    """The full test.py-equivalent pipeline on `device` (default
    `cuda:<cfg.gpu>`; raises without a CUDA device unless device="cpu").
    Returns a metrics dict."""
    device = resolve_device(f"cuda:{cfg.gpu}" if device is None else device)
    set_fp32_matmul_precision()
    if atlas_cfg is None:
        cfg_path = Path(cfg.config)
        atlas_cfg = (load_atlas_config(cfg_path) if cfg_path.exists()
                     else AtlasConfig())

    t_start = time.time()
    frames_dir = prepare_frames(cfg)
    dual = cfg.class_name is not None
    s1 = run_stage1(frames_dir, cfg, atlas_cfg, device, dual=dual,
                    flow_provider=flow_provider)
    s2 = run_stage2(frames_dir, cfg, device, engine=filter_engine)

    total = time.time() - t_start
    out = {**s1, **s2, "t_total": total,
           "frames_per_sec": s1["num_frames"] / total}

    # final-output temporal-consistency metrics (E_warp reads the cached
    # flow).  No blanket except: a fault here must surface.
    from .evaluate import compute_video_metrics

    m = compute_video_metrics(frames_dir, s2["final_dir"], device=device)
    out["final_psnr"] = m["psnr_mean"]
    if "ewarp_mean" in m:
        out["final_ewarp"] = m["ewarp_mean"]
        m_in = compute_video_metrics(frames_dir, frames_dir, device=device)
        out["input_ewarp"] = m_in.get("ewarp_mean")

    ew = (f", E_warp {out['input_ewarp']*100:.3f} -> "
          f"{out['final_ewarp']*100:.3f} (x100)"
          if out.get("final_ewarp") is not None else "")
    print(f"[deflicker_torch] {frames_dir.name}: {s1['num_frames']} frames in "
          f"{total:.1f}s ({out['frames_per_sec']:.2f} fps end-to-end), "
          f"stage-1 PSNR {s1['psnr']:.2f} dB, "
          f"fit {s1['iters_per_sec']:.1f} it/s{ew}, "
          f"final PSNR {out['final_psnr']:.2f} dB")
    return out
