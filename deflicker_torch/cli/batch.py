"""Batch multi-video CLI on a CUDA device.

    python -m deflicker_torch.cli.batch --videos a.mp4 b.mp4 [--gpu N]
    python -m deflicker_torch.cli.batch --video_dir clips/ --parallel_fit \
        [--class_name C]

The default mode runs one full pipeline per video, one after another.
`--parallel_fit` runs flow per video, then ONE V-batched atlas fit per group
of same-shaped videos (atlas/multifit.py: every network query of a step is
one kernel launch for the whole group), then the renders, then stage 2 with
the videos of each resolution advancing in lockstep
(`FilterEngine.run_multi`).  Videos longer than `maximum_number_of_frames`
go through the pipeline's chunked path instead.  Spreading videos over
hosts (`--dcn` in the JAX package) is not ported.

Prints one JSON line per video and an aggregate line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch


def _pipe_cfg(video, args):
    from ..config import PipelineConfig

    return PipelineConfig(
        video_name=video, fps=args.fps, class_name=args.class_name,
        down=args.down, root=args.root, results_root=args.results_root,
        ckpt_raft=args.ckpt_raft, ckpt_filter=args.ckpt_filter,
        ckpt_local=args.ckpt_local, mask_provider=args.mask_provider,
        stage2_dtype=args.stage2_precision, stage2_unpad=args.stage2_unpad)


def run_batch_parallel(videos, args, atlas_cfg, device=None) -> dict:
    """Group-parallel pipeline on `device` (default: the card; raises without
    one unless device="cpu"): flow per video, one V-batched fit per
    same-shape group, render per video, stage 2 per same-resolution group.
    Returns the aggregate summary with a record per video and the stage
    times."""
    from ..atlas import build_specs, load_video_data
    from ..atlas.multifit import fit_group, group_by_shape, save_group
    from ..filter import load_filter_engine
    from ..flow import preprocess_optical_flow
    from ..io.media import list_frames, read_image
    from ..utils.device import (resolve_device, set_fp32_matmul_precision,
                                synchronize)
    from .pipeline import (_generators, _stage1_resolution,
                           make_flow_provider, prepare_frames, run_pipeline)

    device = resolve_device(device)
    set_fp32_matmul_precision()
    dual = args.class_name is not None
    results_root = Path(args.results_root)
    t0 = time.time()

    # flow (and masks) per video; long videos go to the chunked pipeline
    frames_dirs, datas, long_videos = [], [], []
    flow_provider = None
    for v in videos:
        cfg = _pipe_cfg(v, args)
        fd = prepare_frames(cfg)
        if len(list_frames(fd)) > atlas_cfg.maximum_number_of_frames:
            long_videos.append(v)
            continue
        if dual:
            from ..seg import get_mask_provider, preprocess_masks

            preprocess_masks(fd, get_mask_provider(args.class_name,
                                                   args.mask_provider))
        if flow_provider is None:
            flow_provider = make_flow_provider(cfg, device)
        preprocess_optical_flow(fd, flow_provider,
                                max_long_edge=cfg.max_long_edge)
        resy, resx = _stage1_resolution(fd, args.down, dual)
        frames_dirs.append(fd)
        datas.append(load_video_data(fd, resy, resx,
                                     atlas_cfg.maximum_number_of_frames,
                                     use_masks=dual))
    synchronize(device)
    times = {"t_flow": time.time() - t0, "t_pretrain": 0.0, "t_fit": 0.0,
             "t_render": 0.0}

    specs = build_specs(atlas_cfg, dual=dual)
    psnrs = [0.0] * len(datas)
    video_iters = 0
    for g, idxs in enumerate(group_by_shape(datas).values()):
        # seeds seed + 4g .. seed + 4g + 3: each group draws its own streams
        fit = fit_group([datas[i] for i in idxs], specs, atlas_cfg,
                        _generators(atlas_cfg.seed + 4 * g, device), device)
        times["t_pretrain"] += fit["t_pretrain"]
        times["t_fit"] += fit["t_fit"]
        video_iters += len(idxs) * fit["results"][0].iteration
        t3 = time.time()
        outputs = []
        for i in idxs:
            folder = results_root / frames_dirs[i].name / "stage_1"
            folder.mkdir(parents=True, exist_ok=True)
            with open(folder / "config.json", "w") as f:
                json.dump(atlas_cfg.to_reference_json(), f, indent=4)
            outputs.append(dict(folder=folder, texture=folder / "texture"))
        for i, p in zip(idxs, save_group(fit["results"], specs,
                                         [datas[i] for i in idxs], atlas_cfg,
                                         outputs)):
            psnrs[i] = p
        synchronize(device)
        times["t_render"] += time.time() - t3

    # stage 2 per same-resolution group, the videos in lockstep
    t4 = time.time()
    engine = load_filter_engine(args.ckpt_filter, args.ckpt_local,
                                device=device,
                                dtype=getattr(torch, args.stage2_precision),
                                unpad=args.stage2_unpad)
    res_groups = {}
    for i, fd in enumerate(frames_dirs):
        res_groups.setdefault(read_image(list_frames(fd)[0]).shape[:2],
                              []).append(i)
    for idxs in res_groups.values():
        engine.run_multi(
            [(frames_dirs[i],
              results_root / frames_dirs[i].name / "stage_1" / "output",
              results_root / frames_dirs[i].name) for i in idxs],
            fps=args.fps, return_output=False)
    synchronize(device)
    times["t_stage2"] = time.time() - t4

    per_video = []
    for i, fd in enumerate(frames_dirs):
        per_video.append({"video": fd.name, "frames": datas[i].num_frames,
                          "psnr": psnrs[i]})
        print(json.dumps(per_video[-1]))

    # videos past the atlas cap: the pipeline's chunked path, reusing the
    # loaded flow model and stage-2 engine
    for v in long_videos:
        if flow_provider is None:
            flow_provider = make_flow_provider(_pipe_cfg(v, args), device)
        out = run_pipeline(_pipe_cfg(v, args), atlas_cfg, device=device,
                           flow_provider=flow_provider, filter_engine=engine)
        per_video.append({"video": Path(v).stem, "frames": out["num_frames"],
                          "psnr": out["psnr"], "chunks": out.get("chunks")})
        print(json.dumps(per_video[-1]))

    dt = time.time() - t0
    frames = sum(r["frames"] for r in per_video)
    summary = {"videos": len(videos), "frames": frames, "t_total": dt,
               "parallel_fit": True, "frames_per_sec": frames / dt,
               "video_iters_per_sec": (video_iters / times["t_fit"]
                                       if times["t_fit"] > 0 else 0.0),
               **times}
    print(json.dumps(summary))
    return {**summary, "per_video": per_video}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="batch multi-video deflickering on a CUDA device")
    p.add_argument("--videos", nargs="*", default=None, type=str)
    p.add_argument("--video_dir", default=None, type=str,
                   help="process every .mp4/.avi/.mov in this directory")
    p.add_argument("--fps", default=10, type=int)
    p.add_argument("--gpu", default=0, type=int,
                   help="CUDA device index: runs on cuda:N")
    p.add_argument("--class_name", default=None, type=str)
    p.add_argument("--mask_provider", default=None, type=str,
                   choices=["carvekit", "maskrcnn", "grabcut"],
                   help="mask backend of the dual-atlas path (default: "
                        "carvekit for class 'portrait', Mask-RCNN otherwise)")
    p.add_argument("--down", default=None, type=int)
    p.add_argument("--iters", default=None, type=int)
    p.add_argument("--root", default="data/test/", type=str)
    p.add_argument("--results_root", default="results", type=str)
    p.add_argument("--config", default="config_flow_100.json", type=str)
    p.add_argument("--ckpt_raft",
                   default="./pretrained_weights/raft-things.pth", type=str)
    p.add_argument("--ckpt_filter",
                   default="./pretrained_weights/neural_filter.pth", type=str)
    p.add_argument("--ckpt_local",
                   default="./pretrained_weights/local_refinement_net.pth",
                   type=str)
    p.add_argument("--parallel_fit", action="store_true",
                   help="fit same-shaped videos at once (one V-batched fit "
                        "per group)")
    p.add_argument("--stage2_precision", choices=["float32", "bfloat16"],
                   default="bfloat16")
    p.add_argument("--stage2_unpad", choices=["crop", "resize"],
                   default="crop",
                   help="map padded stage-2 outputs back to frame size: "
                        "exact crop (default) or the reference's "
                        "unpad-by-resize quirk")
    p.add_argument("--dcn", action="store_true",
                   help="multi-host fan-out: not ported (ROADMAP.md, item 17)")
    return p


def main(argv=None, device=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.dcn:
        raise NotImplementedError("--dcn (spreading videos over hosts) is not "
                                  "ported yet: ROADMAP.md, item 17")
    videos = list(args.videos or [])
    if args.video_dir:
        for ext in ("*.mp4", "*.avi", "*.mov"):
            videos += [str(v) for v in sorted(Path(args.video_dir).glob(ext))]
    if not videos:
        p.error("no videos given (use --videos or --video_dir)")

    from ..config import AtlasConfig, load_atlas_config
    from ..utils.device import resolve_device
    from .pipeline import run_pipeline

    device = resolve_device(f"cuda:{args.gpu}" if device is None else device)
    cfg_path = Path(args.config)
    atlas_cfg = (load_atlas_config(cfg_path) if cfg_path.exists()
                 else AtlasConfig())
    if args.iters is not None:
        atlas_cfg = dataclasses.replace(
            atlas_cfg, iters_num=args.iters,
            evaluate_every=max(1, args.iters - 1))

    if args.parallel_fit:
        run_batch_parallel(videos, args, atlas_cfg, device=device)
        return 0

    t0 = time.time()
    total_frames = 0
    for v in videos:
        out = run_pipeline(_pipe_cfg(v, args), atlas_cfg, device=device)
        total_frames += out["num_frames"]
        print(json.dumps({"video": Path(v).stem, "frames": out["num_frames"],
                          "t_total": out["t_total"], "psnr": out["psnr"]}))
    dt = time.time() - t0
    print(json.dumps({"videos": len(videos), "frames": total_frames,
                      "t_total": dt, "frames_per_sec": total_frames / dt}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
