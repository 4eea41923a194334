"""Warm serving daemon: one process, one card, many videos.

The reference pays its whole start-up (checkpoint loads, CUDA warm-up) per
video, since test.py spawns a fresh process chain each run.  This daemon
wraps `api.Deflickerer`, so N videos share one warm state: the weights on
the card, the built kernels, and the frames and flow of clips already on
disk.

    # line-oriented job protocol on stdin -> one result JSON line per job
    python -m deflicker_torch.cli.serve [--gpu N]
    {"video": "data/test/a.mp4", "iters": 10001}
    {"frame_folder": "data/test/b", "down": 4}

    # or poll a spool directory for *.json job files
    python -m deflicker_torch.cli.serve --watch jobs/

Job keys mirror `Deflickerer.process`: video | frame_folder, and optional
class_name / down / fps / iters / seed.  Each result line carries the
pipeline's metrics dict plus "ok" (and "error" when a job failed).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def handle_job(d, job: dict) -> dict:
    """Run one job dict through a warm Deflickerer; never raises."""
    t0 = time.perf_counter()
    try:
        allowed = {"video", "frame_folder", "class_name", "down", "fps",
                   "iters", "seed"}
        extra = set(job) - allowed
        if extra:
            raise ValueError(f"unknown job keys: {sorted(extra)} "
                             f"(allowed: {sorted(allowed)})")
        out = d.process(**job)
        out = {k: v for k, v in out.items() if not isinstance(v, Path)}
        out.update(ok=True, wall_s=round(time.perf_counter() - t0, 2))
        return out
    except Exception as e:                      # keep the daemon alive
        return {"ok": False, "error": f"{type(e).__name__}: {e}",
                "job": job, "wall_s": round(time.perf_counter() - t0, 2)}


def serve_lines(d, lines, out=None) -> int:
    """stdin-protocol loop, factored for tests: one JSON job per line,
    one JSON result per line to `out` (sys.stdout when None).  Blank lines
    are ignored; returns the number of jobs processed."""
    out = sys.stdout if out is None else out
    n = 0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            job = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"ok": False, "error": f"bad json: {e}"}),
                  file=out, flush=True)
            continue
        print(json.dumps(handle_job(d, job)), file=out, flush=True)
        n += 1
    return n


def serve_watch(d, spool: Path, poll_s: float = 1.0,
                max_jobs: int | None = None) -> int:
    """Spool-directory loop: pick up `<name>.json` job files (ordered by
    name), write `<name>.result.json` next to each, rename the job file to
    `<name>.done` so the pickup is idempotent across daemon restarts."""
    spool.mkdir(parents=True, exist_ok=True)
    n = 0
    while max_jobs is None or n < max_jobs:
        jobs = sorted(p for p in spool.glob("*.json")
                      if not p.name.endswith(".result.json"))
        if not jobs:
            time.sleep(poll_s)
            continue
        for p in jobs:
            try:
                job = json.loads(p.read_text())
                res = handle_job(d, job)
            except Exception as e:
                res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            (p.parent / (p.stem + ".result.json")).write_text(
                json.dumps(res, indent=1))
            p.rename(p.with_suffix(".done"))
            n += 1
            if max_jobs is not None and n >= max_jobs:
                break
    return n


def main(argv=None, device=None):
    """`device` overrides `cuda:<--gpu>` (the tests pass "cpu")."""
    ap = argparse.ArgumentParser(
        description="warm deflicker daemon (see module docstring)")
    ap.add_argument("--watch", default=None,
                    help="spool directory of *.json job files (default: "
                    "read jobs from stdin)")
    ap.add_argument("--poll_s", type=float, default=1.0)
    ap.add_argument("--max_jobs", type=int, default=None,
                    help="exit after this many jobs (tests / bounded runs)")
    ap.add_argument("--root", default="data/test/")
    ap.add_argument("--results_root", default="results")
    ap.add_argument("--ckpt_raft",
                    default="./pretrained_weights/raft-things.pth")
    ap.add_argument("--ckpt_filter",
                    default="./pretrained_weights/neural_filter.pth")
    ap.add_argument("--ckpt_local",
                    default="./pretrained_weights/local_refinement_net.pth")
    ap.add_argument("--config", default="config_flow_100.json")
    ap.add_argument("--stage2_precision", default="bfloat16")
    ap.add_argument("--stage2_unpad", choices=["crop", "resize"],
                    default="crop")
    ap.add_argument("--gpu", type=int, default=0,
                    help="CUDA device index: serves on cuda:N")
    args = ap.parse_args(argv)

    import torch

    from ..api import Deflickerer

    d = Deflickerer(ckpt_raft=args.ckpt_raft, ckpt_filter=args.ckpt_filter,
                    ckpt_local=args.ckpt_local, config=args.config,
                    root=args.root, results_root=args.results_root,
                    stage2_dtype=args.stage2_precision,
                    stage2_unpad=args.stage2_unpad,
                    device=f"cuda:{args.gpu}" if device is None else device)
    name = (torch.cuda.get_device_name(d.device) if d.device.type == "cuda"
            else str(d.device))
    print(json.dumps({"ok": True, "status": "ready", "device": name}),
          flush=True)
    if args.watch:
        n = serve_watch(d, Path(args.watch), poll_s=args.poll_s,
                        max_jobs=args.max_jobs)
    else:
        lines = sys.stdin
        if args.max_jobs is not None:
            import itertools

            # stop after max_jobs NON-EMPTY job lines
            done = {"n": 0}

            def take(line):
                if line.strip():
                    done["n"] += 1
                return done["n"] <= args.max_jobs

            lines = itertools.takewhile(take, sys.stdin)
        n = serve_lines(d, lines)
    print(json.dumps({"ok": True, "status": "exit", "jobs": n}),
          file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
