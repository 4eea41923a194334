"""Run-to-run reproducibility of stage-2 training at a fixed seed.

    python tools/train_determinism.py [--runs 3] [--deterministic]
        [--cudnn_deterministic] [--filter_steps 25] [--refine_steps 100]
        [--dtype bfloat16]

Runs `cli.train_stage2.main` at chip_smoke's training widths (phase 14:
128x128, batch 8, clips 2 x 6, lr 2e-4 constant, bf16 or `--dtype`, seed
0, chunks of 25) `--runs` times in one process and prints every chunk's `total` per net
and run, then whether the runs agree to the bit.  `--deterministic` runs
them under `torch.use_deterministic_algorithms(True, warn_only=True)` with
cuDNN's benchmark off and prints each distinct warning, which names every
op without a deterministic implementation that the steps reached;
`--cudnn_deterministic` pins only cuDNN's algorithms.  Needs a CUDA card;
prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--cudnn_deterministic", action="store_true")
    ap.add_argument("--filter_steps", type=int, default=25)
    ap.add_argument("--refine_steps", type=int, default=100)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    if args.deterministic:
        # cuBLAS reads this when its first handle is made
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("train_determinism: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deflicker_torch.cli import train_stage2

    print(cs.nvidia_smi_line(), flush=True)
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.benchmark = False
    if args.cudnn_deterministic:
        torch.backends.cudnn.deterministic = True
    shape = [a for k, v in cs.TRAIN_SHAPE.items() for a in (f"--{k}", str(v))]
    runs, seen = [], {}
    for r in range(args.runs):
        out_dir = cs.WORK / "train_determinism" / f"run{r}"
        shutil.rmtree(out_dir, ignore_errors=True)
        argv_r = ["--out_dir", str(out_dir), *shape, "--lr", "2e-4",
                  "--lr_schedule", "constant", "--dtype", args.dtype,
                  "--seed", "0", "--filter_steps", str(args.filter_steps),
                  "--refine_steps", str(args.refine_steps),
                  "--steps_per_call", str(cs.TRAIN_PER_CALL)]
        with warnings.catch_warnings(record=True) as caught, \
                contextlib.redirect_stdout(io.StringIO()):
            warnings.simplefilter("always")
            train_stage2.main(argv_r, device=None)
        for w in caught:
            msg = str(w.message).split("\n")[0]
            seen[msg] = seen.get(msg, 0) + 1
        rows = [json.loads(line) for line in
                (out_dir / "scalars.jsonl").read_text().splitlines()]
        totals = {net: [x["total"] for x in rows if x["net"] == net]
                  for net in ("filter", "refiner")}
        runs.append(totals)
        print(f"[determinism] run {r} " + json.dumps(totals), flush=True)
    for msg, n in seen.items():
        print(f"[determinism] warning x{n}: {msg}", flush=True)
    same = {net: all(r[net] == runs[0][net] for r in runs)
            for net in ("filter", "refiner")}
    spread = {net: max(abs(r[net][0] - runs[0][net][0]) for r in runs)
              for net in ("filter", "refiner")}
    print("[determinism] " + json.dumps({
        "deterministic_mode": args.deterministic,
        "cudnn_deterministic": args.cudnn_deterministic, "runs": args.runs,
        "dtype": args.dtype,
        "bit_equal": same, "first_chunk_max_abs_diff": spread}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
