"""One run of one benchmark cell of deflicker_torch on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (`BENCHMARK.json`'s `workloads`)
names a configuration and a traffic mix; the mix's generator
(`benchmark/drivers/<kind>.py`) makes the inputs and weights from the seed,
warms up every shape the window uses (set-up), measures for `--seconds`,
then checks what the timed path produced against the plain reference
(`benchmark/reference/`).  The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), `device`, with
`--trace 1` `breakdown`, and last `checks`, each number compared beside its
limit; the same numbers close standard error.

Exits non-zero with no result when the card is missing, the program cannot
be imported, or JAX or the JAX package is loaded once the window has
closed.  Build and kernel caches stay in fixed directories under
`build/` of the checkout.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "deflicker_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "nv"}


def environment() -> None:
    """Caches at fixed paths in the checkout; the program's switches off,
    so a run is the configuration as its file states it."""
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench" / "cache" / sub)
    os.environ["USE_FLAX"] = "0"
    for key in [k for k in os.environ if k.startswith("DEFLICKER_")]:
        del os.environ[key]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def driver(cell):
    """The generator of the cell's traffic: `benchmark/drivers/<kind>.py`."""
    return importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}")


def per_layer(cell, out: dict) -> dict:
    from benchmark.core import manifest

    run = types.SimpleNamespace(cell=cell, config=cell.config,
                                traffic=cell.traffic, **out)
    metrics = {}
    for entry in cell.per_layer:
        value = manifest.metric_reader(ROOT, entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return metrics


def judge(cell, out: dict):
    """(correct, checks): every number compared beside its limit."""
    checks = {}
    ok = out["failed"] == 0
    for name, value in out["checks"].items():
        limit = cell.limits[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks


def card() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    sys.path.insert(0, str(ROOT))
    from benchmark.core import manifest

    cell = manifest.cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import deflicker_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: cannot import the program: {e}", file=sys.stderr)
        return 4
    device = torch.device("cuda:0")
    out = driver(cell).measure(cell, args.seed, args.seconds, bool(args.trace),
                               device, T_PROCESS)
    return report(cell, out, bool(args.trace))


def report(cell, out: dict, trace: bool, device_name: str = None) -> int:
    """Print the result line; non-zero, and no line, if a forbidden module
    is loaded."""
    from benchmark.core import trace as tracing

    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 5
    correct, checks = judge(cell, out)
    if trace:
        metrics = per_layer(cell, out)
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    if device_name is None:
        import torch

        device_name = torch.cuda.get_device_name(0)
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = tracing.breakdown(out["trace"])
    line["card"] = card() if device_name != "cpu" else "cpu"
    line["checks"] = checks
    print("setup_s parts: " + json.dumps(out.get("setup_parts", {})), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
