"""Flow-preprocessing CLI — the `src/preprocess_optical_flow.py` equivalent.

    python -m deflicker_torch.cli.preprocess_flow --vid_name X
        [--root data/test/] [--max_long_edge 2000] [--model ckpt] [--gpu N]

`--model` is a RAFT or GMA checkpoint: the flow model is the one its keys
name (GMA's `gma-*.pth` has its attention's `att.to_qk`).  The flow runs
on `cuda:N` (it raises without a CUDA device).  Idempotent: existing
`<vid>_flow/*.npy` pairs are reused.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="RAFT flow preprocessing")
    # reference flags (preprocess_optical_flow.py:37-46)
    p.add_argument("--vid_name", type=str, required=True)
    p.add_argument("--root", type=str, default="data/test/")
    p.add_argument("--max_long_edge", type=int, default=2000)
    p.add_argument("--model", type=str,
                   default="./pretrained_weights/raft-things.pth",
                   help="RAFT or GMA checkpoint (.pth, or RAFT converted): "
                        "its keys pick the model")
    p.add_argument("--gpu", type=int, default=0,
                   help="CUDA device index: runs on cuda:N")
    # extensions
    p.add_argument("--provider", choices=["raft", "farneback"], default="raft")
    p.add_argument("--iters", type=int, default=20,
                   help="RAFT or GMA GRU iterations")
    return p


def main(argv=None, device=None) -> int:
    """`device` overrides `cuda:<--gpu>` (the tests pass "cpu")."""
    from ..flow import FarnebackFlow, RAFTFlow, preprocess_optical_flow

    args = build_parser().parse_args(argv)
    if args.provider == "raft" and Path(args.model).exists():
        provider = RAFTFlow(args.model, iters=args.iters,
                            device=(f"cuda:{args.gpu}" if device is None
                                    else device))
    else:
        if args.provider == "raft":
            print(f"RAFT or GMA checkpoint {args.model} missing; using "
                  "Farneback")
        provider = FarnebackFlow()
    paths = preprocess_optical_flow(Path(args.root) / args.vid_name, provider,
                                    max_long_edge=args.max_long_edge)
    print(f"{len(paths)} flow pairs ready")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
