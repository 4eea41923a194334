"""Stage 2's device memory after the chunked fit, in a fresh process:
chip_smoke's chunked phase alone.

    python tools/stage2_peak.py [ROOT] [--empty-cache]

ROOT is the checkout whose `chip_smoke.py` and `deflicker_torch` run
(default: this one), so two trees, say a change and its parent unpacked
with `git archive`, can be compared in one call.  Builds the kernels,
saves chip_smoke's seeded random RAFT weights, runs `phase_chunked`, and
when stage 2 starts prints the device memory the run holds live (and the
CUDA tensors over 20 MiB among it), the memory reserved and the largest
free cached block, then stage 2's own peak.  `--empty-cache` releases the
cached blocks first.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import gc
import sys
from pathlib import Path


def main(argv) -> int:
    args = [a for a in argv if not a.startswith("--")]
    empty = "--empty-cache" in argv
    root = Path(args[0] if args else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("stage2_peak: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import deflicker_torch.cli.pipeline as pipeline
    from deflicker_torch.models.raft import raft_init
    from deflicker_torch.ops.cuda import build

    print(cs.nvidia_smi_line(), flush=True)
    device = torch.device("cuda:0")
    torch.zeros(1, device=device)          # a context before the peak resets
    build.build(["imlp_chain", "corr_lookup"])
    cs.WORK.mkdir(parents=True, exist_ok=True)
    model = raft_init(torch.Generator().manual_seed(0))
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()},
               cs.WORK / "raft-random.pth")
    del model
    real = pipeline.run_stage2

    def largest_free() -> int:
        return max((b["size"] for seg in torch.cuda.memory_snapshot()
                    for b in seg["blocks"] if b["state"] == "inactive"),
                   default=0)

    def stage2(*a, **k):
        torch.cuda.synchronize()
        print(f"[stage2] live {torch.cuda.memory_allocated() / 2**30:.3f} GiB",
              flush=True)
        big = sorted(((t.untyped_storage().nbytes(), tuple(t.shape), t.dtype)
                      for t in gc.get_objects()
                      if isinstance(t, torch.Tensor) and t.is_cuda
                      and t.untyped_storage().nbytes() > 20 * 2**20),
                     key=lambda x: -x[0])
        for n, shape, dtype in big[:12]:
            print(f"[stage2]   {n / 2**20:9.1f} MiB {shape} {dtype}", flush=True)
        if empty:
            torch.cuda.empty_cache()
        print(f"[stage2] reserved {torch.cuda.memory_reserved() / 2**30:.3f} "
              f"GiB, largest free block {largest_free() / 2**30:.3f} GiB, "
              f"empty_cache {empty}", flush=True)
        torch.cuda.reset_peak_memory_stats()
        out = real(*a, **k)
        torch.cuda.synchronize()
        print(f"[stage2] peak {torch.cuda.max_memory_allocated() / 2**30:.4f} "
              "GiB", flush=True)
        return out

    pipeline.run_stage2 = stage2
    cs.phase_chunked(device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
