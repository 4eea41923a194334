"""Readings that the limits of `correct` are set from, on the card at a
cell's own size, in one process, each taken by the cell's driver
(`benchmark/drivers/<kind>.py`):

  * the program's sound runs, one a seed (`--seeds`): the driver's `sound`,
    what a benchmark run compares, with a short window (`--seconds`) where
    the driver has one;
  * the control (`--control-seeds`): the driver's `control`, the plain
    reference in the program's place one precision below the
    configuration's (fp8 products for its bfloat16 ones), read by the same
    comparison;
  * the driver's `faults`, each planted under the timed path while `sound`
    runs (`--fault-seeds`).

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

from benchmark import run as bench_run


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def rows(cell, device, seeds=(), control_seeds=(), fault_seeds=(), seconds=1.0):
    """One row a reading: {"what", "seed", "readings", ...the driver's detail}."""
    driver = bench_run.driver(cell)
    for seed in seeds:
        readings, more = driver.sound(cell, seed, seconds, device)
        yield {"what": "program", "seed": seed, "readings": readings, **more}
    for seed in control_seeds:
        readings, more = driver.control(cell, seed, device)
        yield {"what": "control", "seed": seed, "readings": readings, **more}
    for name, plant in driver.faults(cell).items():
        for seed in fault_seeds:
            with plant():
                readings, more = driver.sound(cell, seed, seconds, device)
            yield {"what": "fault:" + name, "seed": seed, "readings": readings, **more}


def summary(rows) -> dict:
    """The largest program reading and the smallest control and fault
    readings of every number."""
    out = {}
    for row in rows:
        pick = max if row["what"] == "program" else min
        for name, value in row["readings"].items():
            key = f"{row['what']}/{name}"
            out[key] = pick(out.get(key, value), value)
    return out


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

    from benchmark.core import manifest

    cell = manifest.cell(args.workload, bench_run.ROOT)
    done = []
    for row in rows(cell, torch.device("cuda:0"), args.seeds, args.control_seeds,
                    args.fault_seeds, args.seconds):
        done.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"summary": summary(done)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
