"""The sample-sharded fit captured against eager on several ranks.

    python tools/parallel_graph.py [--ranks 4] [--steps 100] [--cpu]

Spawns `--ranks` ranks (`deflicker_torch.parallel.launch`: NCCL, one card
a rank; with `--cpu`, gloo ranks on the CPU at a small shape, where every
route runs eagerly) and gives each the same fit: configuration 1's shape
(80 frames at 108x192, random frames, flows and masks from seed 0), the
default widths and batch, `--steps` steps with global rigidity on for the
first half.  Each rank runs the sample-sharded fit captured (its own
`FitGraphs`), eagerly (`FitGraphs(eager=True)`) and captured again, all
from one seed after a 5-step warm-up fit (cuBLAS, NCCL's communicator),
then the unsharded captured fit alone on its card.  Prints the card's name
and power limit, then one JSON line: each route's it/s on every rank,
whether every rank's params agree to the bit across the three sharded
routes, whether the ranks agree with each other, and the unsharded fit's
it/s (one card's whole batch) beside them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _data(T, H, W):
    """A clip's arrays at (T, H, W) from seed 0: frames, their gradients,
    a mask, flows both ways and their masks (the fit's time does not
    depend on the content)."""
    import numpy as np

    from deflicker_torch.atlas.data import VideoData

    rng = np.random.default_rng(0)
    video = rng.uniform(0.1, 0.9, (T, H, W, 3)).astype(np.float32)
    dx, dy = np.zeros_like(video), np.zeros_like(video)
    dx[:, :, :-1] = video[:, :, 1:] - video[:, :, :-1]
    dy[:, :-1] = video[:, 1:] - video[:, :-1]
    mask = np.ones((T, H, W), np.float32)
    ffwd = rng.normal(size=(T, H, W, 2)).astype(np.float32)
    fbwd = rng.normal(size=(T, H, W, 2)).astype(np.float32)
    mfwd = (rng.uniform(size=(T, H, W)) > 0.3).astype(np.float32)
    mbwd = (rng.uniform(size=(T, H, W)) > 0.3).astype(np.float32)
    mfwd[-1] = 0.0
    mbwd[0] = 0.0
    return VideoData(video, dx, dy, mask, ffwd, fbwd, mfwd, mbwd)


def _rank(mesh, shape, steps, narrow):
    """One rank: the sharded fit captured, eager, captured again, then the
    unsharded captured fit; it/s and a digest of the params of each."""
    import dataclasses

    import torch

    from deflicker_torch.atlas import build_specs, fit_atlas, init_models
    from deflicker_torch.atlas.engine import flat_params
    from deflicker_torch.atlas.graphs import FitGraphs
    from deflicker_torch.config import AtlasConfig

    device = mesh.device
    cfg = dataclasses.replace(AtlasConfig(), **narrow, iters_num=steps,
                              evaluate_every=steps + 1,
                              stop_global_rigidity=steps // 2)
    data = _data(*shape).with_packed(device)
    specs = build_specs(cfg)
    params = init_models(specs, torch.Generator().manual_seed(0), device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def fit(m, n, graphs):
        p = {k: [{kk: vv.detach().clone().requires_grad_()
                  for kk, vv in layer.items()} for layer in v]
             for k, v in params.items()}
        sync()
        t0 = time.time()
        fit_atlas(p, specs, data, dataclasses.replace(cfg, iters_num=n),
                  torch.Generator(device).manual_seed(2), mesh=m,
                  graphs=graphs)
        sync()
        flat = torch.cat([q.detach().reshape(-1) for q in flat_params(p)])
        digest = hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()
        return n / (time.time() - t0), digest, graphs.captured

    fit(mesh, 5, FitGraphs())
    runs = {name: fit(mesh, steps, FitGraphs(eager=name == "eager"))
            for name in ("captured", "eager", "captured_again")}
    runs["unsharded"] = fit(None, steps, FitGraphs())
    return {name: {"it_s": r[0], "params_sha256": r[1], "graphs": r[2]}
            for name, r in runs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU at a small shape (a rehearsal)")
    args = ap.parse_args(argv)
    import torch

    from deflicker_torch.parallel import launch

    if args.cpu:
        shape = (4, 16, 20)
        narrow = dict(number_of_channels_atlas=32, number_of_layers_atlas=4,
                      number_of_channels_mapping1=32,
                      number_of_layers_mapping1=3,
                      positional_encoding_num_atlas=6, samples_batch=97)
    else:
        if torch.cuda.device_count() < args.ranks:
            print(f"parallel_graph: {args.ranks} ranks need as many CUDA "
                  f"devices, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 1
        import chip_smoke as cs

        print(cs.nvidia_smi_line(), flush=True)
        shape, narrow = (cs.CLIP[0], cs.CLIP[1] // 4, cs.CLIP[2] // 4), {}
    t0 = time.time()
    ranks = launch(_rank, args.ranks, "cpu" if args.cpu else "cuda",
                   (shape, args.steps, narrow), timeout=900)
    sharded = ("captured", "eager", "captured_again")
    digests = {r[name]["params_sha256"] for r in ranks for name in sharded}
    out = {"ranks": args.ranks, "backend": "gloo" if args.cpu else "nccl",
           "shape": shape, "steps": args.steps, "wall_s": time.time() - t0,
           "routes_bit_equal": all(len({r[n]["params_sha256"]
                                        for n in sharded}) == 1
                                   for r in ranks),
           "ranks_bit_equal": len(digests) == 1,
           **{f"{name}_it_s": [r[name]["it_s"] for r in ranks]
              for name in sharded + ("unsharded",)},
           "graphs": {name: [r[name]["graphs"] for r in ranks]
                      for name in sharded + ("unsharded",)}}
    print("[parallel-graph] " + json.dumps(out), flush=True)
    return 0 if out["routes_bit_equal"] and out["ranks_bit_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
