"""Evaluation: PSNR + E_warp (the paper's temporal-consistency metric) of a
processed video, as `run_pipeline` reports them, and its CLI:

    python -m deflicker_torch.cli.evaluate --video_name X
        [--target final] [--root data/test/] [--results_root results] [--gpu N]

which prints one JSON line of the metrics (computed on `cuda:N`).

E_warp follows the reference's (dead-code) recipe — occlusion-masked mean
squared warp error between consecutive frames using the cached flow
(src/models/utils.py:532-572; see deflicker_torch.metrics.ewarp).  PSNR is
measured between the processed frames and the originals.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def compute_video_metrics(frames_dir: Path, processed_dir: Path,
                          flow_dir: Path | None = None, device=None) -> dict:
    """PSNR of `processed_dir` against `frames_dir` and E_warp of the
    processed frames with the cached flow, computed on `device` (CUDA unless
    the caller names another; raises without CUDA)."""
    from ..io.media import list_frames, read_image
    from ..metrics import psnr
    from ..utils.device import resolve_device

    device = resolve_device(device)

    orig_files = list_frames(frames_dir)
    proc_files = list_frames(processed_dir)
    assert len(orig_files) > 0, f"no frames in {frames_dir}"
    T = min(len(orig_files), len(proc_files))
    flow_dir = flow_dir or frames_dir.parent / f"{frames_dir.name}_flow"

    import cv2

    from ..metrics.ewarp import warp_error_video

    # warp error runs in batches of CHUNK pairs on `device`: one
    # whole-video stack would be O(T*H*W) memory
    CHUNK = 16
    psnrs, ewarps = [], []
    f1s, f2s, fws, bws = [], [], [], []

    def flush():
        if not f1s:
            return
        vals = warp_error_video(np.stack(f1s), np.stack(f2s),
                                np.stack(fws), np.stack(bws), device=device)
        ewarps.extend(vals)
        f1s.clear(); f2s.clear(); fws.clear(); bws.clear()

    prev = None
    for t in range(T):
        orig = read_image(orig_files[t])
        proc = read_image(proc_files[t])
        if proc.shape != orig.shape:
            proc = cv2.resize(proc, (orig.shape[1], orig.shape[0]),
                              interpolation=cv2.INTER_LINEAR)
        psnrs.append(psnr(orig, proc))
        if prev is not None:
            fn1, fn2 = orig_files[t - 1].name, orig_files[t].name
            p12 = flow_dir / f"{fn1}_{fn2}.npy"
            p21 = flow_dir / f"{fn2}_{fn1}.npy"
            if p12.exists() and p21.exists():
                f12, f21 = np.load(p12), np.load(p21)
                if f12.shape[:2] != prev.shape[:2]:
                    from ..ops.consistency import resize_flow

                    f12 = resize_flow(f12, prev.shape[0], prev.shape[1])
                    f21 = resize_flow(f21, prev.shape[0], prev.shape[1])
                f1s.append(prev); f2s.append(proc)
                fws.append(f12); bws.append(f21)
                if len(f1s) == CHUNK:
                    flush()
        prev = proc
    flush()
    out = {"psnr_mean": float(np.mean(psnrs)), "num_frames": T}
    if len(ewarps):
        out["ewarp_mean"] = float(np.mean(ewarps))
        out["ewarp_x100"] = float(np.mean(ewarps) * 100.0)
    return out


def main(argv=None, device=None) -> int:
    """`device` overrides `cuda:<--gpu>` (the tests pass "cpu")."""
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser(description="PSNR + E_warp evaluation")
    p.add_argument("--video_name", required=True, type=str)
    p.add_argument("--root", default="data/test/", type=str)
    p.add_argument("--results_root", default="results", type=str)
    p.add_argument("--target", default="final",
                   choices=["final", "stage_1", "neural_filter", "input"],
                   help="which output to evaluate (input = the original)")
    p.add_argument("--gpu", type=int, default=0,
                   help="CUDA device index: computes on cuda:N")
    args = p.parse_args(argv)
    device = resolve_device(f"cuda:{args.gpu}" if device is None else device)

    frames_dir = Path(args.root) / args.video_name
    results = Path(args.results_root) / args.video_name
    processed = {"input": frames_dir,
                 "stage_1": results / "stage_1" / "output",
                 "neural_filter": results / "neural_filter" / "output",
                 "final": results / "final" / "output"}[args.target]
    out = compute_video_metrics(frames_dir, processed, device=device)
    out["target"] = args.target
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
