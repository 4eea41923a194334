"""Stage-1-only CLI, the `src/stage1_neural_atlas[_seg].py` equivalent, on a
CUDA device.

    python -m deflicker_torch.cli.stage1 --vid_name X [--config cfg.json]
        [--root data/test/] [--down 4] [--seg] [--class_name Y] [--gpu N]

Runs flow preprocessing (idempotent), then the atlas fit on `cuda:N`,
writing `<results_root>/<vid>/stage_1/{output/%05d.png, checkpoint,
config.json}`.  `--seg` or `--class_name` takes the dual-atlas path, with
masks from `<root>/<vid>_seg` (written by the mask provider where they are
missing).  The JAX CLI's `--mesh_devices` has no counterpart: one card
runs the fit until multi-GPU is ported (ROADMAP.md, item 17).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="stage 1: neural atlas fit")
    # reference flags (stage1_neural_atlas.py:259-264)
    p.add_argument("--config", type=str, default="config_flow_100.json")
    p.add_argument("--vid_name", type=str, required=True)
    p.add_argument("--root", type=str, default="data/test/")
    p.add_argument("--down", type=int, default=None)
    p.add_argument("--gpu", type=int, default=0,
                   help="CUDA device index: runs on cuda:N")
    # extensions
    p.add_argument("--results_root", type=str, default="results")
    p.add_argument("--seg", action="store_true",
                   help="dual-atlas path (stage1_neural_atlas_seg equivalent)")
    p.add_argument("--class_name", type=str, default=None)
    p.add_argument("--mask_provider", default=None,
                   choices=[None, "carvekit", "maskrcnn", "grabcut"])
    p.add_argument("--ckpt_raft",
                   default="./pretrained_weights/raft-things.pth", type=str)
    p.add_argument("--max_long_edge", type=int, default=2000)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--fit_precision", choices=["highest", "default"],
                   default=None, help="fit matmul precision (see AtlasConfig)")
    return p


def main(argv=None, device=None) -> int:
    """`device` overrides `cuda:<--gpu>` (the tests pass "cpu")."""
    import dataclasses
    from pathlib import Path

    from ..config import AtlasConfig, PipelineConfig, load_atlas_config
    from ..utils.device import resolve_device, set_fp32_matmul_precision
    from .pipeline import run_stage1

    args = build_parser().parse_args(argv)
    device = resolve_device(f"cuda:{args.gpu}" if device is None else device)
    set_fp32_matmul_precision()
    dual = args.seg or args.class_name is not None
    cfg = PipelineConfig(root=args.root, results_root=args.results_root,
                         down=args.down, ckpt_raft=args.ckpt_raft,
                         max_long_edge=args.max_long_edge,
                         class_name=args.class_name, gpu=args.gpu,
                         mask_provider=args.mask_provider)
    cfg_path = Path(args.config)
    atlas_cfg = (load_atlas_config(cfg_path) if cfg_path.exists()
                 else AtlasConfig())
    if args.iters is not None:
        atlas_cfg = dataclasses.replace(
            atlas_cfg, iters_num=args.iters,
            evaluate_every=max(1, args.iters - 1))
    if args.fit_precision is not None:
        atlas_cfg = dataclasses.replace(atlas_cfg,
                                        fit_precision=args.fit_precision)

    frames_dir = Path(args.root) / args.vid_name
    if dual:
        from ..seg import get_mask_provider, preprocess_masks

        preprocess_masks(frames_dir,
                         get_mask_provider(args.class_name, args.mask_provider))

    out = run_stage1(frames_dir, cfg, atlas_cfg, device, dual=dual)
    print(f"stage 1 done: PSNR {out['psnr']:.2f} dB, "
          f"{out['iters_per_sec']:.1f} it/s -> {out['results_folder']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
