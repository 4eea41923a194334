"""Warm serving from a cold process: chip_smoke's serve phase alone.

    python tools/serve_cold.py

In `chip_smoke.py` the serve phase runs last, after every other phase has
initialised the card, cuBLAS and cuDNN and loaded both kernel libraries, so
its first job is cold only in the RAFT and stage-2 weights it loads.  Here
the phase runs in a fresh process, as a newly started server: the kernel
libraries are built on disk first (as a restarted server finds them), and
the first job pays the CUDA start-up, the libraries' load and the weights'
load.  Needs a CUDA card and nvcc; prints the card's name and power limit
first, then chip_smoke's `[serve]` lines.
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
        print("serve_cold: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deflicker_torch.models.raft import raft_init
    from deflicker_torch.ops.cuda import build

    print(cs.nvidia_smi_line(), flush=True)
    t0 = time.time()
    build.build(["imlp_chain", "corr_lookup"])      # on disk, not loaded
    print(f"[build] nvcc {time.time() - t0:.1f} s", flush=True)
    shutil.rmtree(cs.WORK, ignore_errors=True)
    cs.WORK.mkdir(parents=True)
    # the seeded random RAFT of chip_smoke's RAFT phase
    model = raft_init(torch.Generator().manual_seed(0))
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()},
               cs.WORK / "raft-random.pth")
    t0 = time.time()
    cs.phase_serve(torch.device("cuda:0"))
    print(f"[serve] wall {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
