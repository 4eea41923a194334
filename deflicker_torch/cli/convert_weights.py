"""Checkpoint conversion CLI: torch .pth -> pickled variables.

    python -m deflicker_torch.cli.convert_weights --kind raft \
        --src pretrained_weights/raft-things.pth --dst raft-things.ckpt [--gpu N]
    python -m deflicker_torch.cli.convert_weights --kind filter \
        --src pretrained_weights/neural_filter.pth --dst neural_filter.ckpt

Writes the file of plain numpy that this package and the JAX package both
read: the RAFT's `{"params", "batch_stats"}` (`load_raft_checkpoint`), or
the stage-2 net's `{"params"}` (`--kind filter` the UNet, `--kind local`
the TransformNet; `filter/convert.py`).  The net is loaded on `cuda:N`
first (strict, so a checkpoint with a missing or unexpected key fails
here, on the device that will run it); it raises without a CUDA device.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None, device=None) -> int:
    """`device` overrides `cuda:<--gpu>` (the tests pass "cpu")."""
    p = argparse.ArgumentParser(description="torch -> pickled-variables "
                                            "weight conversion")
    p.add_argument("--kind", required=True,
                   choices=["raft", "filter", "local"],
                   help="raft-things / neural_filter / local_refinement_net")
    p.add_argument("--src", required=True, type=str, help="torch .pth path")
    p.add_argument("--dst", required=True, type=str,
                   help="output path (pickled variables)")
    p.add_argument("--gpu", type=int, default=0,
                   help="CUDA device index: loads on cuda:N")
    args = p.parse_args(argv)

    from ..utils.checkpoint import save_checkpoint
    from ..utils.device import resolve_device

    device = resolve_device(f"cuda:{args.gpu}" if device is None else device)
    if args.kind == "raft":
        from ..flow.convert import load_raft_checkpoint
        from ..utils.convert import raft_variables_from_state_dict

        model = load_raft_checkpoint(args.src).to(device)
        variables = raft_variables_from_state_dict(model.state_dict())
    else:
        from ..filter.convert import variables_from_state_dict
        from ..models.refine import TransformNet
        from ..models.unet import UNet
        from ..utils.convert import load_stage2_module

        model = UNet() if args.kind == "filter" else TransformNet()
        model = load_stage2_module(model, args.src).to(device)
        variables = variables_from_state_dict(model.state_dict())
    save_checkpoint(args.dst, variables)
    n = sum(v.numel() for v in model.parameters())
    print(f"{args.kind}: {n:,} parameters -> {Path(args.dst).resolve()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
