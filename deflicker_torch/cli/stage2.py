"""Stage-2-only CLI, the `src/neural_filter_and_refinement.py` equivalent,
on a CUDA device.

    python -m deflicker_torch.cli.stage2 --video_name X [--fps 10]
        [--ckpt_filter ...] [--ckpt_local ...] [--gpu N]

Reads `<root>/<vid>` and `<results_root>/<vid>/stage_1/output`, writes
`<results_root>/<vid>/{neural_filter/{concat,output},final/output}` and
their mp4s.  The weights are the reference's `.pth` files or the shipped
`.ckpt` beside them (`filter.load_filter_engine`).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="stage 2: filter + refinement")
    # reference flags (neural_filter_and_refinement.py:19-24)
    p.add_argument("--ckpt_filter",
                   default="./pretrained_weights/neural_filter.pth", type=str)
    p.add_argument("--ckpt_local",
                   default="./pretrained_weights/local_refinement_net.pth",
                   type=str)
    p.add_argument("--fps", default=10, type=int)
    p.add_argument("--video_name", default=None, type=str, required=True)
    p.add_argument("--gpu", type=int, default=0,
                   help="CUDA device index: runs on cuda:N")
    # extensions
    p.add_argument("--root", type=str, default="data/test/")
    p.add_argument("--results_root", type=str, default="results")
    return p


def main(argv=None, device=None) -> int:
    """`device` overrides `cuda:<--gpu>` (the tests pass "cpu")."""
    from ..config import PipelineConfig
    from ..utils.device import resolve_device, set_fp32_matmul_precision
    from .pipeline import run_stage2

    args = build_parser().parse_args(argv)
    device = resolve_device(f"cuda:{args.gpu}" if device is None else device)
    set_fp32_matmul_precision()
    cfg = PipelineConfig(fps=args.fps, ckpt_filter=args.ckpt_filter,
                         ckpt_local=args.ckpt_local, root=args.root,
                         results_root=args.results_root, gpu=args.gpu)
    out = run_stage2(Path(args.root) / args.video_name, cfg, device)
    print(f"stage 2 done -> {out['final_dir']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
