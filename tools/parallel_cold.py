"""chip_smoke's parallel phase alone, in a fresh process.

    python tools/parallel_cold.py

Makes what the phase reads from earlier phases of `chip_smoke.py`: the
kernel libraries, configuration 1's 80-frame clip with its Farneback flow,
the seeded random RAFT `.pth` and one rank's RAFT flow of the clip with
it, and the serve phase's two 40-frame clips
(their flow is solved by the `--dcn` processes).  Then runs
`chip_smoke.phase_parallel`: the sharded fit at world size 1 under NCCL
against the unsharded fit, configuration 1's pipeline on two ranks sharing
the card under gloo against one rank, and `cli.batch --dcn` as two
processes.  Needs a CUDA card and nvcc; prints the card's name and power
limit first, then chip_smoke's `[parallel]` lines.
"""

from __future__ import annotations

import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("parallel_cold: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deflicker_torch.flow import (FarnebackFlow, RAFTFlow,
                                      preprocess_optical_flow)
    from deflicker_torch.models.raft import raft_init
    from deflicker_torch.ops.cuda import build

    print(cs.nvidia_smi_line(), flush=True)
    t0 = time.time()
    build.build(["imlp_chain", "corr_lookup"])
    print(f"[build] nvcc {time.time() - t0:.1f} s", flush=True)
    shutil.rmtree(cs.WORK, ignore_errors=True)
    frames = cs.WORK / "data" / "clip"
    cs.make_clip(frames)
    preprocess_optical_flow(frames, FarnebackFlow(), verbose=False)
    model = raft_init(torch.Generator().manual_seed(0))
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()},
               cs.WORK / "raft-random.pth")
    # one rank's RAFT solve of the clip, as chip_smoke's raft phase makes it
    raft_frames = cs.WORK / "data_raft" / frames.name
    shutil.copytree(frames, raft_frames)
    preprocess_optical_flow(raft_frames, RAFTFlow(
        cs.WORK / "raft-random.pth", device=torch.device("cuda:0")),
        verbose=False)
    for seed, name in ((5, "clipa"), (6, "clipb")):
        cs.make_clip(cs.WORK / "data_serve" / name, seed=seed,
                     T=cs.SERVE_FRAMES)
    t0 = time.time()
    cs.phase_parallel(torch.device("cuda:0"), frames,
                      raft_frames.parent / f"{frames.name}_flow")
    print(f"[parallel] wall {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
