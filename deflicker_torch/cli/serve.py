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
pipeline's metrics dict plus "ok" (and "error" when a job failed),
"graphs": what the job added to the CUDA graphs' counters
(`utils/trace.py`: `graphs.state_made`, `graphs.state_loaded`,
`graphs.evicted`, `graphs.warmup_s`, `graphs.capture_s`), and "flow": what
it added to the flow engine's (`flow.staging_made`, the pinned staging
buffers made or grown).  A warm server whose jobs keep making states is
capturing again: a new shape, or more shapes than the kept graphs hold.
A job that makes staging brought larger frames than any job before it.

Under `torchrun` with several ranks (one card each) the `Deflickerer`
spans them (parallel/mesh.py): rank 0 alone reads stdin or the spool and
hands each job to every rank, all ranks run it together, and rank 0
writes the results.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from ..parallel.mesh import broadcast_object, is_main
from ..utils import trace


def handle_job(d, job: dict) -> dict:
    """Run one job dict through a warm Deflickerer; never raises."""
    t0 = time.perf_counter()
    before = trace.counters()
    try:
        allowed = {"video", "frame_folder", "class_name", "down", "fps",
                   "iters", "seed"}
        extra = set(job) - allowed
        if extra:
            raise ValueError(f"unknown job keys: {sorted(extra)} "
                             f"(allowed: {sorted(allowed)})")
        out = d.process(**job)
        out = {k: v for k, v in out.items() if not isinstance(v, Path)}
        out.update(ok=True, wall_s=round(time.perf_counter() - t0, 2),
                   graphs=counter_growth(before, "graphs"),
                   flow=counter_growth(before, "flow"))
        return out
    except Exception as e:                      # keep the daemon alive
        return {"ok": False, "error": f"{type(e).__name__}: {e}",
                "job": job, "wall_s": round(time.perf_counter() - t0, 2)}


def counter_growth(before: dict, group: str) -> dict:
    """The `<group>.*` counters' growth since `before`, by name."""
    prefix = group + "."
    return {k[len(prefix):]: round(v - before.get(k, 0), 3)
            for k, v in trace.counters().items()
            if k.startswith(prefix) and v != before.get(k, 0)}


def serve_lines(d, lines, out=None) -> int:
    """stdin-protocol loop, factored for tests: one JSON job per line,
    one JSON result per line to `out` (sys.stdout when None).  Blank lines
    are ignored; returns the number of jobs processed.  With a mesh on
    `d`, rank 0 reads `lines` and hands every line to the other ranks."""
    out = sys.stdout if out is None else out
    mesh = getattr(d, "mesh", None)
    main = is_main(mesh)
    lines = iter(lines) if main else None
    n = 0
    while True:
        line = broadcast_object(next(lines, None) if main else None, mesh)
        if line is None:
            return n
        line = line.strip()
        if not line:
            continue
        try:
            job = json.loads(line)
        except json.JSONDecodeError as e:
            if main:
                print(json.dumps({"ok": False, "error": f"bad json: {e}"}),
                      file=out, flush=True)
            continue
        res = handle_job(d, job)
        if main:
            print(json.dumps(res), file=out, flush=True)
        n += 1


def serve_watch(d, spool: Path, poll_s: float = 1.0,
                max_jobs: int | None = None) -> int:
    """Spool-directory loop: pick up `<name>.json` job files (ordered by
    name), write `<name>.result.json` next to each, rename the job file to
    `<name>.done` so the pickup is idempotent across daemon restarts.  With
    a mesh on `d`, rank 0 polls and hands each job file's text to the
    other ranks."""
    mesh = getattr(d, "mesh", None)
    main = is_main(mesh)
    if main:
        spool.mkdir(parents=True, exist_ok=True)
    n = 0
    while max_jobs is None or n < max_jobs:
        jobs = (sorted(p for p in spool.glob("*.json")
                       if not p.name.endswith(".result.json"))
                if main else None)
        jobs = broadcast_object(
            [(p, p.read_text()) for p in jobs] if main else None, mesh)
        if not jobs:
            time.sleep(poll_s)
            continue
        for p, text in jobs:
            try:
                res = handle_job(d, json.loads(text))
            except Exception as e:
                res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            if main:
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
    from ..parallel import make_mesh

    make_mesh()      # under torchrun: the world group, for mesh="auto"
    d = Deflickerer(ckpt_raft=args.ckpt_raft, ckpt_filter=args.ckpt_filter,
                    ckpt_local=args.ckpt_local, config=args.config,
                    root=args.root, results_root=args.results_root,
                    stage2_dtype=args.stage2_precision,
                    stage2_unpad=args.stage2_unpad,
                    device=f"cuda:{args.gpu}" if device is None else device)
    name = (torch.cuda.get_device_name(d.device) if d.device.type == "cuda"
            else str(d.device))
    if is_main(d.mesh):
        print(json.dumps({"ok": True, "status": "ready", "device": name,
                          "mesh": d.mesh and d.mesh.shape}), flush=True)
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
    if is_main(d.mesh):
        print(json.dumps({"ok": True, "status": "exit", "jobs": n}),
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
