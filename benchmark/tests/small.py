"""Cells at sizes a CPU test can run: the configurations' keys, with the
widths, batch, schedule and frames cut down."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark.core.manifest import Cell

ROOT = Path(__file__).resolve().parents[2]


def _config(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def _limits(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "limits" / f"{name}.json").read_text())


def fit_cell(dual: bool = False, videos: int = 1) -> Cell:
    name = "dual-fit" if dual else ("single-fit-v4" if videos > 1 else "single-fit")
    config = copy.deepcopy(_config("deflicker-dual" if dual else "deflicker-single"))
    config["frame_size"] = [48, 64]
    config["down"] = 2 if not dual else 1
    atlas = config["atlas"]
    for key in ("number_of_channels_mapping1", "number_of_channels_atlas",
                "number_of_channels_mapping2", "number_of_channels_alpha"):
        atlas[key] = 32
    atlas.update(samples_batch=512, iters_num=24, stop_global_rigidity=10,
                 stop_bootstrapping_iteration=16, evaluate_every=20,
                 steps_per_call=5, global_rigidity_derivative_amount_fg=4,
                 global_rigidity_derivative_amount_bg=4)
    return Cell(name=name, root=ROOT, config=config,
                traffic={"kind": "fit", "videos": videos, "frames": 6},
                chips=1, limits=_limits(name), end_to_end=[], per_layer=[])


def flow_cell() -> Cell:
    config = copy.deepcopy(_config("deflicker-single"))
    config["frame_size"] = [128, 128]
    config["raft"].update(iters=6, pair_batch=2)
    return Cell(name="single-flow", root=ROOT, config=config,
                traffic={"kind": "flow", "frames": 4}, chips=1,
                limits=_limits("single-flow"), end_to_end=[], per_layer=[])
