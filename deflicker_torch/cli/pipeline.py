"""End-to-end pipeline: decode -> (masks) -> flow -> atlas fit -> render ->
filter.

Stages call each other as functions, and every stage reads and writes the
reference's filesystem artifacts, so each stays independently runnable and
idempotent.  The port runs the single-atlas path and, with `class_name`
set, the dual-atlas path (foreground masks, four networks, texture export)
on one device, with RAFT flow when a RAFT checkpoint is on disk (GMA flow
when the checkpoint there is GMA's).  A video
longer than `maximum_number_of_frames` takes the chunked path: equal chunks
fit at once as one multi-video group (atlas/multifit.py), every frame is
rendered, and stage 2 runs unbroken over the whole video.

With a mesh (parallel/mesh.py) every rank calls the same stage functions
with the same arguments: the flow pairs, the fit's sample batch (the
chunked fit's video axis), the render's frames and stage 2's U-Net frames
split over the ranks, and rank 0 alone writes, with a barrier wherever the
others next read what it wrote.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..atlas import (build_specs, evaluate_and_save, export_atlas_artifacts,
                     fit_atlas, init_models, load_video_data, pretrain_mapping,
                     save_mask_flow_videos)
from ..config import AtlasConfig, PipelineConfig, load_atlas_config
from ..flow import FarnebackFlow, RAFTFlow, preprocess_optical_flow
from ..io.media import list_frames, read_image, video_to_frames
from ..parallel.mesh import Mesh, barrier, broadcast_object, is_main
from ..utils.checkpoint import host_adam_state, load_checkpoint
from ..utils.convert import atlas_params_from_jax
from ..utils.device import (resolve_device, set_fp32_matmul_precision,
                            synchronize)
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


class _NullLogger:
    """The ScalarLogger of a rank that writes nothing."""

    def log(self, step, scalars) -> None:
        pass

    def log_image(self, step, tag, image) -> None:
        pass

    def close(self) -> None:
        pass


def _logger(folder: Path, mesh: Optional[Mesh]):
    return ScalarLogger(folder) if is_main(mesh) else _NullLogger()


def make_flow_provider(cfg: PipelineConfig, device=None,
                       mesh: Optional[Mesh] = None):
    """RAFT on `device` when its checkpoint is on disk (the torch `.pth` or
    the JAX package's converted file), else Farneback on the host; a GMA
    `.pth` at that path runs GMA (`flow/convert.py` reads the architecture
    from its keys).  With `mesh`, the flow runs on the rank's device and
    splits each pair batch."""
    ckpt = Path(cfg.ckpt_raft)
    for candidate in (ckpt, ckpt.with_suffix(".pth")):
        if candidate.exists():
            return RAFTFlow(candidate, device=device, mesh=mesh)
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
    """(init, pretrain mapping1, fit, pretrain mapping2) generators from one
    seed.  Init draws on the CPU, so a seed gives the same initial weights
    on every device; mapping2's pretrain has a generator of its own, so the
    single-atlas run draws the same streams whether or not a dual run
    exists."""
    init = torch.Generator().manual_seed(seed)
    pre = torch.Generator(device=device).manual_seed(seed + 1)
    fit = torch.Generator(device=device).manual_seed(seed + 2)
    pre2 = torch.Generator(device=device).manual_seed(seed + 3)
    return init, pre, fit, pre2


def _chunk_starts(T_all: int, cap: int):
    """Equal-size chunk starts covering [0, T_all); the last chunk is
    anchored backward (overlapping its predecessor) so every chunk has the
    same length and the chunks fit as one multi-video group."""
    n = -(-T_all // cap)
    size = -(-T_all // n)
    starts = [min(k * size, T_all - size) for k in range(n)]
    return size, starts


def _run_stage1_chunked(frames_dir: Path, atlas_cfg: AtlasConfig,
                        device: torch.device, dual: bool, resy: int, resx: int,
                        results_folder: Path, mesh: Optional[Mesh] = None,
                        graphs=None) -> Dict:
    """Long-video stage 1: T > maximum_number_of_frames (the JAX package's
    `_run_stage1_chunked`).

    The reference truncates at the cap and tells users to split long videos
    by hand (README.md:117), which also resets stage 2's temporal
    consistency at every split.  Here the video is split into equal chunks
    (`_chunk_starts`), all chunks fit at once as one V-batched group
    (atlas/multifit.py), every frame is rendered with continuous numbering,
    and stage 2 later runs its recurrence unbroken across the whole video.
    Chunk edges take video-edge flow semantics (zero flow and consistency at
    a chunk's boundary frame), what a manual split would produce.

    Checkpoint and resume: the group state (params, Adam moments, the fit
    generator's state) is written to `<stage_1>/checkpoint` at the eval
    cadence and at the fit's end; with `load_checkpoint` set, a checkpoint
    of the same chunking resumes the group fit and replays the
    uninterrupted run's samples.  A group checkpoint of the JAX package
    (`opt_state_v`, `key_data`) resumes its params, Adam moments and
    iteration; its JAX PRNG state cannot be replayed here, so the samples
    restart from the port's fit generator.  With `mesh` the chunks split
    over the ranks (`multifit.fit_group`); `graphs` is `run_stage1`'s."""
    from ..atlas.multifit import fit_group, save_group
    from ..utils.checkpoint import save_checkpoint

    T_all = len(list_frames(frames_dir))
    size, starts = _chunk_starts(T_all, atlas_cfg.maximum_number_of_frames)
    n = len(starts)
    print(f"[deflicker_torch] {frames_dir.name}: {T_all} frames > cap "
          f"{atlas_cfg.maximum_number_of_frames} -> {n} chunks of {size}, "
          "fit as one group", flush=True)
    datas = [load_video_data(frames_dir, resy, resx, size, use_masks=dual,
                             start_frame=s) for s in starts]
    # masked-flow / input diagnostic videos, one set per chunk
    for k, d in enumerate(datas if is_main(mesh) else ()):
        save_mask_flow_videos(d, results_folder / f"chunk_{k:02d}")
    specs = build_specs(atlas_cfg, dual=dual)
    ckpt_file = results_folder / "checkpoint"

    def save_group_ckpt(iteration, state):
        if is_main(mesh):
            save_checkpoint(ckpt_file, {**state, "iteration": int(iteration),
                                        "chunk_starts": starts,
                                        "chunk_size": size, "dual": dual})

    resume = None
    if atlas_cfg.load_checkpoint:
        path = Path(atlas_cfg.checkpoint_path or ckpt_file)
        if path.exists():
            c = load_checkpoint(path)
            if "params_v" not in c or not ("generator_state" in c
                                           or "key_data" in c):
                raise ValueError(f"{path} is not a chunked-fit checkpoint "
                                 "(no params_v, or neither generator_state "
                                 "nor key_data)")
            jax_group = "generator_state" not in c
            if list(c.get("chunk_starts", [])) == list(starts) \
                    and c.get("chunk_size") == size:
                resume = dict(c, opt_state_v=host_adam_state(
                    c.get("opt_state_v"), c["params_v"]))
                print(f"[deflicker_torch] resuming the chunked fit at "
                      f"iteration {int(c['iteration'])} from {path}")
                if jax_group:
                    print("[deflicker_torch] the JAX package's PRNG state "
                          "(key_data) cannot be replayed: params, Adam "
                          "moments and iteration resume, samples restart "
                          "from this package's fit generator")
            else:
                print(f"[deflicker_torch] checkpoint {path} does not match "
                      f"this chunking ({c.get('chunk_starts')} vs {starts}) — "
                      "starting fresh")

    logger = _logger(results_folder, mesh)
    fit = fit_group(
        datas, specs, atlas_cfg, _generators(atlas_cfg.seed, device), device,
        resume=resume, checkpoint_callback=save_group_ckpt,
        log_callback=lambda i, v, rec: logger.log(
            i, {f"chunk{v}/{k}": val for k, val in rec.items()}), mesh=mesh,
        graphs=graphs)
    results = fit["results"]

    t3 = time.time()
    outputs = []
    for k in range(n):
        prev_end = starts[k - 1] + size if k else 0
        outputs.append(dict(
            folder=results_folder,
            texture=results_folder / "texture" / f"chunk_{k:02d}",
            frame_offset=starts[k], first_saved_frame=max(0, prev_end - starts[k]),
            save_video=(k == n - 1), save_ckpt=False, psnr_marker=False))
    psnrs = save_group(results, specs, datas, atlas_cfg, outputs, mesh)
    # weighted by written frames: the backward-anchored last chunk writes
    # fewer frames than it fits
    weights = [size - o["first_saved_frame"] for o in outputs]
    mean_psnr = float(np.average(psnrs, weights=weights))
    if is_main(mesh):
        (results_folder / f"PSNR_{mean_psnr:.2f}").touch()
    synchronize(device)
    t_render = time.time() - t3
    logger.close()

    iters = results[0].iteration - fit["start_iteration"]
    t_fit = fit["t_fit"]
    return {"psnr": mean_psnr, "num_frames": T_all, "res": (resy, resx),
            "iterations": iters, "t_pretrain": fit["t_pretrain"],
            "t_fit": t_fit, "t_render": t_render,
            "iters_per_sec": n * iters / t_fit if t_fit > 0 else 0.0,
            "chunks": n}


def fit_profiler(device: torch.device):
    """DEFLICKER_PROFILE=<dir>: a torch.profiler window over the fit (host
    activity, and the card's where the fit runs on one) whose Chrome trace
    is written under <dir> when it closes; unset, no profiler."""
    prof_dir = os.environ.get("DEFLICKER_PROFILE")
    if not prof_dir:
        return contextlib.nullcontext()
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(prof_dir))


def run_stage1(frames_dir: Path, cfg: PipelineConfig,
               atlas_cfg: AtlasConfig, device, dual: bool = False,
               results_root: Optional[Path] = None,
               flow_provider=None, mesh: Optional[Mesh] = None,
               graphs=None) -> Dict:
    """Flow preprocessing + atlas fit + render
    (src/stage1_neural_atlas[_seg].py main()).  `dual` reads the
    `<vid>_seg` masks, fits mapping2 and alpha beside mapping1 and the
    atlas, and exports the fg/bg textures after the final render.  Videos
    longer than `maximum_number_of_frames` take the chunked path
    (`_run_stage1_chunked`) instead of the reference's truncation;
    `iters_per_sec` then counts video-iterations (chunks x steps).  With
    `load_checkpoint` and `checkpoint_path` set, the fit resumes from a
    checkpoint of this package or of the JAX package.  DEFLICKER_PROFILE
    traces the fit (`fit_profiler`).  With `mesh` (every rank calls it
    alike, `device` is the rank's) the flow pairs, the fit's samples and
    the render's frames split over the ranks; rank 0 writes, and all
    return once the stage's files are on disk.  On the card the pretrains
    and the fit run as CUDA graphs (atlas/graphs.py): captured anew for
    this fit, or replayed from `graphs` (a kept `FitGraphs`, a
    `Deflickerer`'s) when an earlier fit had this shape."""
    device = torch.device(mesh.device if mesh is not None else device)
    t0 = time.time()
    if flow_provider is None:
        flow_provider = make_flow_provider(cfg, device, mesh)
    preprocess_optical_flow(frames_dir, flow_provider,
                            max_long_edge=cfg.max_long_edge, mesh=mesh)
    t_flow = time.time() - t0

    vid = frames_dir.name
    results_root = Path(results_root or cfg.results_root)
    results_folder = results_root / vid / "stage_1"
    if is_main(mesh):
        results_folder.mkdir(parents=True, exist_ok=True)
        with open(results_folder / "config.json", "w") as f:
            json.dump(atlas_cfg.to_reference_json(), f, indent=4)

    resy, resx = _stage1_resolution(frames_dir, cfg.down, dual)
    T_all = len(list_frames(frames_dir))
    if T_all > atlas_cfg.maximum_number_of_frames:
        out = _run_stage1_chunked(frames_dir, atlas_cfg, device, dual, resy,
                                  resx, results_folder, mesh, graphs)
        out.update(results_folder=results_folder, t_flow=t_flow)
        barrier(mesh)
        return out

    data = load_video_data(frames_dir, resy, resx,
                           atlas_cfg.maximum_number_of_frames,
                           use_masks=dual)
    T, (H, W) = data.num_frames, data.res
    if is_main(mesh):
        save_mask_flow_videos(data, results_folder)

    specs = build_specs(atlas_cfg, dual=dual)
    g_init, g_pre, g_fit, g_pre2 = _generators(atlas_cfg.seed, device)

    start_iteration = 0
    opt_state = None
    t_pretrain = 0.0          # stays 0 on the resume branch (no pretrain)
    if atlas_cfg.load_checkpoint and atlas_cfg.checkpoint_path:
        # the port's own checkpoint or the JAX package's (optax Adam state)
        ckpt = load_checkpoint(atlas_cfg.checkpoint_path)
        params = atlas_params_from_jax(ckpt["params"], device)
        opt_state = host_adam_state(ckpt.get("opt_state"), ckpt["params"])
        start_iteration = int(ckpt["iteration"])
    else:
        params = init_models(specs, g_init, device)
        t1 = time.time()
        if atlas_cfg.pretrain_mapping1:
            pretrain_mapping(params["mapping1"], specs.mapping1, g_pre, T, H, W,
                             atlas_cfg.uv_mapping_scale,
                             atlas_cfg.pretrain_iter_number, graphs=graphs)
        if dual and atlas_cfg.pretrain_mapping2:
            pretrain_mapping(params["mapping2"], specs.mapping2, g_pre2, T, H,
                             W, atlas_cfg.uv_mapping_scale,
                             atlas_cfg.pretrain_iter_number, graphs=graphs)
        synchronize(device)
        t_pretrain = time.time() - t1

    logger = _logger(results_folder, mesh)

    def eval_cb(iteration, p, opt):
        evaluate_and_save(p, specs, data, atlas_cfg, results_folder,
                          iteration, opt, mesh=mesh)

    with fit_profiler(device):
        t2 = time.time()
        result = fit_atlas(params, specs, data, atlas_cfg, g_fit,
                           start_iteration=start_iteration,
                           opt_state=opt_state, eval_callback=eval_cb,
                           log_callback=lambda i, rec: logger.log(i, rec),
                           mesh=mesh, graphs=graphs)
        synchronize(device)
        t_fit = time.time() - t2        # the trace's export is not in it

    # final render (the reference's eval at iteration iters_num-1 == 10000)
    t3 = time.time()
    rendered, mean_psnr = evaluate_and_save(
        result.params, specs, data, atlas_cfg, results_folder,
        result.iteration - 1, result.opt_state, mesh=mesh)
    if dual and is_main(mesh):
        # fg/bg texture PNGs + alpha maps (the dual evaluator's artifact
        # set, reference: evaluate.py:203-602)
        export_atlas_artifacts(result.params, specs, data,
                               results_folder / "texture")
    synchronize(device)
    t_render = time.time() - t3
    logger.log_image(result.iteration - 1, "reconstruction", rendered[0])
    logger.log_image(result.iteration - 1, "input", np.asarray(data.video[0]))
    logger.close()
    barrier(mesh)

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
               style_dir: Optional[Path] = None, engine=None,
               mesh: Optional[Mesh] = None) -> Dict:
    """Neural filter + local refinement (src/neural_filter_and_refinement.py).
    With `mesh` the U-Net frames split over the ranks and rank 0 writes."""
    from ..filter import load_filter_engine

    device = torch.device(mesh.device if mesh is not None else device)
    vid = frames_dir.name
    results_root = Path(results_root or cfg.results_root)
    style_dir = style_dir or results_root / vid / "stage_1" / "output"
    t0 = time.time()
    if engine is None:
        engine = load_filter_engine(cfg.ckpt_filter, cfg.ckpt_local,
                                    device=device,
                                    dtype=getattr(torch, cfg.stage2_dtype),
                                    unpad=cfg.stage2_unpad, mesh=mesh)
    engine.run(frames_dir, style_dir, results_root / vid, fps=cfg.fps,
               return_output=False)
    synchronize(device)
    return {"t_stage2": time.time() - t0,
            "final_dir": results_root / vid / "final" / "output"}


def run_pipeline(cfg: PipelineConfig, atlas_cfg: Optional[AtlasConfig] = None,
                 device=None, flow_provider=None, filter_engine=None,
                 mesh: Optional[Mesh] = None, graphs=None) -> Dict:
    """The full test.py-equivalent pipeline on `device` (default
    `cuda:<cfg.gpu>`; raises without a CUDA device unless device="cpu").
    Returns a metrics dict.  With `mesh` every rank calls it alike, on its
    rank's device; every rank returns the same metrics.  `graphs`: the
    stage-1 fit's kept CUDA graphs (`run_stage1`)."""
    if mesh is not None:
        device = mesh.device
    device = resolve_device(f"cuda:{cfg.gpu}" if device is None else device)
    set_fp32_matmul_precision()
    if atlas_cfg is None:
        cfg_path = Path(cfg.config)
        atlas_cfg = (load_atlas_config(cfg_path) if cfg_path.exists()
                     else AtlasConfig())

    t_start = time.time()
    dual = cfg.class_name is not None
    frames_dir = None
    if is_main(mesh):
        frames_dir = prepare_frames(cfg)
        if dual:
            from ..seg import get_mask_provider, preprocess_masks

            provider = get_mask_provider(cfg.class_name, cfg.mask_provider)
            preprocess_masks(frames_dir, provider)
    frames_dir = broadcast_object(frames_dir, mesh)   # a barrier too
    s1 = run_stage1(frames_dir, cfg, atlas_cfg, device, dual=dual,
                    flow_provider=flow_provider, mesh=mesh, graphs=graphs)
    s2 = run_stage2(frames_dir, cfg, device, engine=filter_engine, mesh=mesh)

    total = time.time() - t_start
    out = {**s1, **s2, "t_total": total,
           "frames_per_sec": s1["num_frames"] / total}

    # final-output temporal-consistency metrics (E_warp reads the cached
    # flow), on rank 0.  No blanket except: a fault here must surface.
    from .evaluate import compute_video_metrics

    metrics = {}
    if is_main(mesh):
        m = compute_video_metrics(frames_dir, s2["final_dir"], device=device)
        metrics["final_psnr"] = m["psnr_mean"]
        if "ewarp_mean" in m:
            metrics["final_ewarp"] = m["ewarp_mean"]
            m_in = compute_video_metrics(frames_dir, frames_dir,
                                         device=device)
            metrics["input_ewarp"] = m_in.get("ewarp_mean")
    out.update(broadcast_object(metrics, mesh))

    ew = (f", E_warp {out['input_ewarp']*100:.3f} -> "
          f"{out['final_ewarp']*100:.3f} (x100)"
          if out.get("final_ewarp") is not None else "")
    if is_main(mesh):
        print(f"[deflicker_torch] {frames_dir.name}: {s1['num_frames']} "
              f"frames in {total:.1f}s ({out['frames_per_sec']:.2f} fps "
              f"end-to-end), stage-1 PSNR {s1['psnr']:.2f} dB, "
              f"fit {s1['iters_per_sec']:.1f} it/s{ew}, "
              f"final PSNR {out['final_psnr']:.2f} dB")
    return out
