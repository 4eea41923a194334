"""Readings that the limits of `correct` are set from, on the card at a
cell's own size, in one process:

  * the program's sound runs, one a seed (`--seeds`): set-up, a short window
    (`--seconds`) and the comparison, as a benchmark run makes them;
  * the control (`--control-seeds`): the plain reference in the program's
    place, one precision below the configuration's (fp8 products for its
    bfloat16 ones), read by the same comparison against the float32
    reference;
  * the faults of `benchmark/faults.py` planted under the timed path
    (`--fault-seeds`), each run as a sound run is.

    python3 -m benchmark.calibrate --workload single-fit --seeds 1,2,3 \\
        --control-seeds 4,5,6 --fault-seeds 7,8,9 --seconds 1

Prints one JSON line a reading, then the largest program reading and the
smallest control and fault readings of every number.  The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import run as bench_run


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def detail(found: dict, ref: dict, params0) -> dict:
    """Where the fit's readings come from: each step's loss gap, the median
    kept leaf's gradient and change gaps, and the three worst leaves."""
    import numpy as np
    import torch

    from benchmark.drivers import fit
    from benchmark.reference import nla

    start = {k: t.detach().cpu() for k, t in nla.leaves(params0).items()}
    ref_grad = {k: t.cpu() for k, t in ref["grad"].items()}
    kept = fit.kept_leaves(ref_grad)
    out = {"term_gaps": fit.term_gaps(found, ref),
           "kept": len(kept), "leaves": sum(t.shape[0] for t in ref_grad.values())}
    for name, (p, r) in {
            "grad": ({k: t.cpu() for k, t in found["grad"].items()}, ref_grad),
            "update": ({k: found["params"][k] - start[k] for k in start},
                       {k: ref["params"][k].cpu() - start[k] for k in start})}.items():
        gaps = fit.leaf_gaps(p, r, kept)
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        out[name + "_median_leaf_gap"] = float(np.median(list(gaps.values())))
        out[name + "_worst"] = [[f"{k[0]}[{k[1]}]", v] for k, v in worst]
    return out


def program_fit(cell, seed, device) -> tuple:
    """A sound run's readings of the fit's first three steps (the probe
    that a benchmark run makes in set-up), and their detail."""
    from benchmark.drivers import fit

    inp = fit.inputs(cell, seed, device)
    prog = fit.Program(inp.atlas, inp.dual, inp.pack, str(cell.scratch / "rescue"))
    found, params0, probe_seed = fit.probe(prog, inp)
    del prog
    inp.pack = None
    ref = fit.reference(inp, params0, probe_seed)
    return fit.readings(found, ref, params0), detail(found, ref, params0)


def control_fit(cell, seed, device) -> dict:
    from benchmark.drivers import fit

    inp = fit.inputs(cell, seed, device)
    params0, gen = fit.job(inp, "probe")
    ref = fit.reference(inp, params0, gen.initial_seed())
    low = fit.as_probe(fit.reference(inp, params0, gen.initial_seed(),
                                     precision="fp8"))
    return fit.readings(low, ref, params0), detail(low, ref, params0)


def control_flow(cell, seed, device) -> dict:
    import torch

    from benchmark.data.clips import frames_uint_levels
    from benchmark.drivers import flow
    from benchmark.reference import raft as reference

    config = cell.config
    frames = frames_uint_levels(config["clip"], cell.traffic["frames"],
                                config["frame_size"], seed, device).cpu().numpy()
    weights = flow.make_weights(seed, device, getattr(torch, config["raft"]["dtype"]))
    plan = flow.batches(cell.traffic["frames"], config["raft"]["pair_batch"])
    gaps = []
    for ks in (plan[0], plan[1], plan[-1]):
        a, b = (torch.from_numpy(x).to(device) for x in flow.stacked(frames, ks))
        want = reference.flow(reference.Model(weights), a, b, config["raft"]["iters"])
        got = reference.flow(reference.Model(weights, "fp8"), a, b,
                             config["raft"]["iters"])
        gaps.append(flow.flow_gap(got.cpu().numpy(), want.cpu().numpy()))
    return {"flow_epe": max(gaps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    bench_run.environment()
    import torch

    from benchmark import faults
    from benchmark.core import manifest

    cell = manifest.cell(args.workload, bench_run.ROOT)
    kind = cell.traffic["kind"]
    driver = __import__(f"benchmark.drivers.{kind}", fromlist=["measure"])
    device = torch.device("cuda:0")
    rows = []

    def emit(what, seed, readings, **extra):
        row = {"what": what, "seed": seed, "readings": readings, **extra}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def sound(seed):
        if kind == "fit":
            readings, more = program_fit(cell, seed, device)
            return readings, {"detail": more}
        out = driver.measure(cell, seed, args.seconds, False, device,
                             time.perf_counter())
        return out["checks"], {"failed": out["failed"], "e2e": out["e2e"]}

    for seed in args.seeds:
        readings, more = sound(seed)
        emit("program", seed, readings, **more)
    for seed in args.control_seeds:
        if kind == "fit":
            readings, more = control_fit(cell, seed, device)
            emit("control", seed, readings, detail=more)
        else:
            emit("control", seed, control_flow(cell, seed, device))
    for name, plant in faults.FAULTS[kind].items():
        for seed in args.fault_seeds:
            with plant():
                readings, more = sound(seed)
            emit("fault:" + name, seed, readings, **more)
    summary = {}
    for row in rows:
        for name, value in row["readings"].items():
            pick = max if row["what"] == "program" else min
            summary[f"{row['what']}/{name}"] = pick(summary.get(f"{row['what']}/{name}", value), value)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
