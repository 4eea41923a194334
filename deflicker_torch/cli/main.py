"""The test.py-compatible CLI (reference: test.py:4-11 public flags) plus
framework extensions, running the port on a CUDA device.

    python -m deflicker_torch --video_name data/test/X.mp4 [--gpu N]
    python -m deflicker_torch --video_name data/test/X.mp4 --class_name dog \
        [--mask_provider grabcut]          # dual atlas (fg + bg layers)
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

from ..config import AtlasConfig, PipelineConfig, load_atlas_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Blind video deflickering on a CUDA device")
    # --- reference-compatible flags (test.py:4-11) ---
    p.add_argument("--video_name", default=None, type=str,
                   help="input video path")
    p.add_argument("--video_frame_folder", default=None, type=str,
                   help="folder of input frames (alternative to --video_name)")
    p.add_argument("--fps", default=10, type=int)
    p.add_argument("--gpu", default=0, type=int,
                   help="CUDA device index: runs on cuda:N")
    p.add_argument("--class_name", default=None, type=str,
                   help="segmentation class: runs the dual-atlas fit (fg and "
                        "bg layers) with masks from <vid>_seg, written by "
                        "the mask provider where they are missing")
    p.add_argument("--ckpt_filter",
                   default="./pretrained_weights/neural_filter.pth", type=str)
    p.add_argument("--ckpt_local",
                   default="./pretrained_weights/local_refinement_net.pth",
                   type=str)
    # --- stage-1 flags (stage1_neural_atlas.py:259-264) ---
    p.add_argument("--config", default="config_flow_100.json", type=str,
                   help="stage-1 hyperparameter JSON (reference format)")
    p.add_argument("--down", default=None, type=int,
                   help="downscale factor (default: 4; 1 with --class_name)")
    p.add_argument("--root", default="data/test/", type=str)
    p.add_argument("--results_root", default="results", type=str)
    p.add_argument("--max_long_edge", default=2000, type=int)
    # --- extensions ---
    p.add_argument("--ckpt_raft",
                   default="./pretrained_weights/raft-things.pth", type=str)
    p.add_argument("--iters", default=None, type=int,
                   help="override stage-1 iters_num")
    p.add_argument("--seed", default=None, type=int,
                   help="override stage-1 RNG seed")
    p.add_argument("--fit_precision", choices=["highest", "default"],
                   default=None,
                   help="stage-1 matmul precision: highest=fp32 (reference "
                        "numerics), default=bf16 multiply through the fused "
                        "chain kernel")
    p.add_argument("--stage2_precision", choices=["float32", "bfloat16"],
                   default="bfloat16",
                   help="stage-2 conv dtype (float32 = reference numerics)")
    p.add_argument("--stage2_unpad", choices=["crop", "resize"],
                   default="crop",
                   help="map padded stage-2 outputs back to frame size: "
                        "crop = exact (default), resize = the reference's "
                        "squashing unpad-by-resize quirk")
    p.add_argument("--mask_provider", default=None,
                   choices=[None, "carvekit", "maskrcnn", "grabcut"],
                   help="mask backend of the dual-atlas path (default: "
                        "carvekit for class 'portrait', Mask-RCNN otherwise; "
                        "grabcut needs no extra package)")
    return p


def args_to_configs(args) -> tuple[PipelineConfig, AtlasConfig]:
    cfg = PipelineConfig(
        video_name=args.video_name,
        video_frame_folder=args.video_frame_folder,
        fps=args.fps, class_name=args.class_name, gpu=args.gpu,
        ckpt_filter=args.ckpt_filter, ckpt_local=args.ckpt_local,
        ckpt_raft=args.ckpt_raft, config=args.config, down=args.down,
        root=args.root, results_root=args.results_root,
        max_long_edge=args.max_long_edge, mask_provider=args.mask_provider,
        stage2_dtype=args.stage2_precision,
        stage2_unpad=args.stage2_unpad)
    cfg_path = Path(args.config)
    atlas_cfg = (load_atlas_config(cfg_path) if cfg_path.exists()
                 else AtlasConfig())
    overrides = {}
    if args.iters is not None:
        overrides["iters_num"] = args.iters
        overrides["evaluate_every"] = max(1, args.iters - 1)
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.fit_precision is not None:
        overrides["fit_precision"] = args.fit_precision
    if overrides:
        atlas_cfg = dataclasses.replace(atlas_cfg, **overrides)
    return cfg, atlas_cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.video_name is None and args.video_frame_folder is None:
        print("error: need --video_name or --video_frame_folder",
              file=sys.stderr)
        return 2
    cfg, atlas_cfg = args_to_configs(args)

    from .pipeline import run_pipeline

    run_pipeline(cfg, atlas_cfg, device=f"cuda:{args.gpu}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
