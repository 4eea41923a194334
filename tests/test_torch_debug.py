"""The numerics sanitizer (utils/debug.py, DEFLICKER_DEBUG_NANS) and the fit
profiler (DEFLICKER_PROFILE) of the port, on the CPU."""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deflicker_torch.utils.debug import (assert_all_finite,
                                         numerics_debug_enabled)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

# a fused chain whose weight holds a NaN, under a zero upstream gradient:
# the chain's own backward (dx = g W^T) is the first to return a NaN
ANOMALY_PROBE = """
import torch, deflicker_torch
from deflicker_torch.utils.debug import numerics_debug_enabled
from deflicker_torch.ops.cuda.imlp_kernel import fused_imlp_linear_chain
print("anomaly", torch.is_anomaly_enabled(), numerics_debug_enabled())
g = torch.Generator().manual_seed(0)
layers = [{"w": torch.randn(4, 8, generator=g), "b": torch.zeros(8)},
          {"w": torch.randn(8, 2, generator=g), "b": torch.zeros(2)}]
layers[1]["w"][0, 0] = float("nan")
x = torch.randn(16, 4, generator=g, requires_grad=True)
out = fused_imlp_linear_chain(layers, x, (), torch.float32)
try:
    (out * 0).sum().backward()
    print("no error")
except RuntimeError as e:
    print("raised", str(e).splitlines()[0])
"""


@pytest.mark.parametrize("flag", ["1", None])
def test_debug_nans_env_turns_on_anomaly_mode(flag):
    """DEFLICKER_DEBUG_NANS=1 at import turns on autograd's anomaly mode, and
    the NaN the chain's backward returns raises naming the chain's
    autograd Function; unset, anomaly mode stays off and the NaN passes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("DEFLICKER_DEBUG_NANS", None)
    if flag:
        env["DEFLICKER_DEBUG_NANS"] = flag
    out = subprocess.run([sys.executable, "-c", ANOMALY_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    if flag:
        assert lines[0] == "anomaly True True"
        assert lines[1].startswith("raised") and "_FusedChain" in lines[1], lines
    else:
        assert lines[0] == "anomaly False False"
        assert lines[1] == "no error"


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_assert_all_finite_raises_naming_the_tree(bad):
    tree = {"a": [torch.ones(3), {"b": torch.tensor([1.0, bad])}],
            "n": np.zeros(2, np.float32)}
    with pytest.raises(FloatingPointError, match="'params'"):
        assert_all_finite(tree, "params")
    with pytest.raises(FloatingPointError):
        assert_all_finite((np.array([bad]),), "host")


def test_assert_all_finite_passes_a_finite_tree_through():
    """A finite tree comes back as the same object; integer and boolean
    leaves (which cannot hold a NaN) and non-array leaves are ignored."""
    tree = {"w": torch.randn(4, 4), "i": torch.arange(3), "m": torch.ones(2) > 0,
            "h": np.arange(3.0), "step": 3, "name": "x",
            "nested": ([torch.zeros(1, dtype=torch.bfloat16)],)}
    assert assert_all_finite(tree, "t") is tree
    assert not numerics_debug_enabled()      # nothing above turned it on


def test_profile_env_writes_a_trace_of_the_fit(tmp_path, monkeypatch):
    """DEFLICKER_PROFILE=<dir> wraps the fit of run_stage1 in torch.profiler
    and writes a Chrome trace there (CPU activity only on the CPU); the fit
    itself runs as without it."""
    import cv2

    from deflicker_torch.cli.pipeline import run_stage1
    from deflicker_torch.config import AtlasConfig, PipelineConfig

    frames = tmp_path / "data" / "vid"
    frames.mkdir(parents=True)
    rng = np.random.default_rng(0)
    base = rng.uniform(40, 215, (48, 64, 3)).astype(np.uint8)
    for t in range(3):
        cv2.imwrite(str(frames / f"{t:05d}.png"), np.roll(base, t, axis=1))
    prof = tmp_path / "prof"
    monkeypatch.setenv("DEFLICKER_PROFILE", str(prof))
    atlas_cfg = dataclasses.replace(
        AtlasConfig(), iters_num=4, samples_batch=64, steps_per_call=2,
        evaluate_every=3, pretrain_iter_number=1, number_of_channels_atlas=16,
        number_of_layers_atlas=3, number_of_channels_mapping1=16,
        number_of_layers_mapping1=3, stop_global_rigidity=2)
    cfg = PipelineConfig(video_frame_folder=str(frames), root=str(frames.parent),
                         results_root=str(tmp_path / "results"), down=2,
                         ckpt_raft=str(tmp_path / "missing.pth"))
    out = run_stage1(frames, cfg, atlas_cfg, "cpu")
    assert out["iterations"] == 4 and math.isfinite(out["psnr"])
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("Optimizer.step" in n for n in names)     # the fit's steps
