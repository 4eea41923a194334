"""Checkpoint conversion CLI: torch .pth -> pickled variables.

    python -m deflicker_torch.cli.convert_weights --kind raft \
        --src pretrained_weights/raft-things.pth --dst raft-things.ckpt [--gpu N]

Writes the `{"params", "batch_stats"}` file of plain numpy that this
package and the JAX package both read (`load_raft_checkpoint`).  The RAFT is
loaded on `cuda:N` first (strict, so a checkpoint with a missing or
unexpected key fails here, on the device that will run it); it raises
without a CUDA device.  `--kind filter|local` are not ported: reading the
reference's `.pth` stage-2 weights is still queued in ROADMAP.md.
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
    if args.kind != "raft":
        raise NotImplementedError(
            f"--kind {args.kind}: reading the reference's .pth stage-2 weights "
            "is not ported yet (see ROADMAP.md); the port reads the shipped "
            "pretrained_weights/*.ckpt files")

    from ..flow.convert import load_raft_checkpoint
    from ..utils.checkpoint import save_checkpoint
    from ..utils.convert import raft_variables_from_state_dict
    from ..utils.device import resolve_device

    device = resolve_device(f"cuda:{args.gpu}" if device is None else device)
    model = load_raft_checkpoint(args.src).to(device)
    save_checkpoint(args.dst, raft_variables_from_state_dict(model.state_dict()))
    n = sum(v.numel() for v in model.parameters())
    print(f"raft: {n:,} parameters -> {Path(args.dst).resolve()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
