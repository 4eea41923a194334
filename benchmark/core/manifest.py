"""The benchmark's manifest (`BENCHMARK.json`) and the files a cell is made
of, found by the names in it:

  * a configuration: the `file` its entry names;
  * a traffic mix: `benchmark/traffic/<traffic>.json`, whose "kind" names the
    generator that reads it (`benchmark/drivers/<kind>.py`);
  * the limits its comparison holds the run to: `benchmark/limits/<cell>.json`;
  * a per-layer metric: `benchmark/metrics/<name>.py`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def scratch(self) -> Path:
        """Where a run may write (inside the checkout, listed in .gitignore)."""
        path = self.root / "build" / "bench"
        path.mkdir(parents=True, exist_ok=True)
        return path


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: Path) -> Cell:
    bench = load(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m
           or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if
                 (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    here = root / "benchmark"
    return Cell(name=name, root=root,
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((here / "traffic" / f"{entry['traffic']}.json")
                                   .read_text()),
                chips=entry["chips"],
                limits=json.loads((here / "limits" / f"{name}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer)


def metric_reader(root: Path, name: str):
    """The module of per-layer metric `name`."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
