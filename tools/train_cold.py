"""Stage-2 training from a cold process: chip_smoke's training phase alone.

    python tools/train_cold.py

In `chip_smoke.py` the training phase runs last, after every other phase
has run on the card, and the host runs slower there than in a fresh
process.  Here the phase runs in a fresh process.  Its check of the
trained checkpoints through `cli.stage2` needs the serve phase's clip B and
a stage-1 output for it: this script writes the clip and copies its frames
as that output (stage 2 reads any frames there); the clip is also the
phase's texture bank.  Needs a CUDA card; prints the card's name and power
limit first, then chip_smoke's `[train]` lines and both routes' lines,
captured and eager (`[train-profile-<net>-<route>]`, `[train-graphs]`).
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
        print("train_cold: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    print(cs.nvidia_smi_line(), flush=True)
    shutil.rmtree(cs.WORK, ignore_errors=True)
    clip = cs.WORK / "data_serve" / "clipb"
    cs.make_clip(clip, seed=6, T=cs.SERVE_FRAMES)
    shutil.copytree(clip, cs.WORK / "results_serve" / "clipb" / "stage_1"
                    / "output")
    t0 = time.time()
    cs.phase_train(torch.device("cuda:0"))
    print(f"[train] wall {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
