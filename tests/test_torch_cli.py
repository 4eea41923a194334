"""The port's one-card CLIs against the JAX package's: `cli.stage1`,
`cli.stage2` and `cli.evaluate` write the same artifact tree and print the
same JSON keys (tiny widths, on the CPU), and the console scripts of
pyproject.toml import."""

import dataclasses
import importlib
import json
import re
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from deflicker_tpu.cli import evaluate as jevaluate
from deflicker_tpu.cli import stage1 as jstage1
from deflicker_tpu.cli import stage2 as jstage2

from deflicker_torch.cli import evaluate as tevaluate
from deflicker_torch.cli import stage1 as tstage1
from deflicker_torch.cli import stage2 as tstage2
from deflicker_torch.config import AtlasConfig

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "pretrained_weights"
TINY = dict(iters_num=20, samples_batch=128, steps_per_call=10,
            evaluate_every=19, pretrain_iter_number=2,
            number_of_channels_atlas=32, number_of_layers_atlas=4,
            number_of_channels_mapping1=32, number_of_layers_mapping1=3,
            stop_global_rigidity=10)


def tree(folder: Path) -> set:
    """Relative paths of the files under `folder`, with the run-specific
    parts of two names masked: the PSNR marker's value and the TensorBoard
    event file's host and time."""
    out = set()
    for p in folder.rglob("*"):
        if p.is_file():
            rel = str(p.relative_to(folder))
            rel = re.sub(r"PSNR_[-0-9.inf]+$", "PSNR_*", rel)
            rel = re.sub(r"events\.out\.tfevents\..*$", "events.out.tfevents.*",
                         rel)
            out.add(rel)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One tiny clip through both packages' stage-1 and stage-2 CLIs (the
    JAX one on one device: `--mesh_devices 1`), from the same config file
    and the shipped stage-2 weights."""
    import cv2

    tmp = tmp_path_factory.mktemp("cli")
    root = tmp / "data"
    frames = root / "vid"
    frames.mkdir(parents=True)
    rng = np.random.default_rng(0)
    base = rng.uniform(40, 215, (48, 64, 3)).astype(np.float32)
    for t in range(4):
        f = np.clip(np.roll(base, t, axis=1) * (1.0 + 0.1 * ((-1) ** t)), 0, 255)
        cv2.imwrite(str(frames / f"{t:05d}.png"), f.astype(np.uint8))
    config = tmp / "config.json"
    config.write_text(json.dumps(dataclasses.asdict(
        dataclasses.replace(AtlasConfig(), **TINY))))
    common = ["--root", str(root), "--config", str(config), "--down", "2",
              "--ckpt_raft", str(tmp / "missing.pth")]
    s2 = ["--video_name", "vid", "--root", str(root),
          "--ckpt_filter", str(WEIGHTS / "neural_filter.ckpt"),
          "--ckpt_local", str(WEIGHTS / "local_refinement_net.ckpt")]
    assert jstage1.main(["--vid_name", "vid", "--results_root",
                         str(tmp / "jax"), "--mesh_devices", "1", *common]) == 0
    assert tstage1.main(["--vid_name", "vid", "--results_root",
                         str(tmp / "torch"), *common], device="cpu") == 0
    assert jstage2.main([*s2, "--results_root", str(tmp / "jax")]) == 0
    assert tstage2.main([*s2, "--results_root", str(tmp / "torch")],
                        device="cpu") == 0
    return tmp, root


def test_stage_clis_write_the_jax_artifact_tree(runs):
    """stage1.main then stage2.main: the same files under `<vid>/` as the
    JAX CLIs (stage_1/{output, checkpoint, config.json, ...},
    neural_filter/{concat, output}, final/output and the mp4s), the same
    config.json, four frames in each output folder."""
    tmp, _ = runs
    want, got = tree(tmp / "jax" / "vid"), tree(tmp / "torch" / "vid")
    assert got == want, (sorted(got - want), sorted(want - got))
    for rel in ("stage_1/checkpoint", "stage_1/config.json", "final/output.mp4",
                "stage_1/output/00003.png", "final/output/00003.png"):
        assert rel in got, rel
    j, t = (json.loads((tmp / p / "vid/stage_1/config.json").read_text())
            for p in ("jax", "torch"))
    assert t == j


@pytest.mark.parametrize("target", ["final", "stage_1", "neural_filter", "input"])
def test_evaluate_cli_prints_the_jax_keys(runs, target, capsys):
    """evaluate.main prints one JSON line with the JAX CLI's keys; on the
    input (the same frames and flow in both) the values agree: PSNR exactly,
    E_warp within rtol 1e-5 (f32 warp, summation order)."""
    tmp, root = runs
    out = {}
    for name, main, kw in (("jax", jevaluate.main, {}),
                           ("torch", tevaluate.main, {"device": "cpu"})):
        assert main(["--video_name", "vid", "--root", str(root),
                     "--results_root", str(tmp / name), "--target", target],
                    **kw) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        out[name] = json.loads(lines[-1])
    assert set(out["torch"]) == set(out["jax"])
    assert out["torch"]["target"] == target and out["torch"]["num_frames"] == 4
    assert "ewarp_mean" in out["torch"]
    if target == "input":
        assert out["torch"]["psnr_mean"] == out["jax"]["psnr_mean"]
        np.testing.assert_allclose(out["torch"]["ewarp_mean"],
                                   out["jax"]["ewarp_mean"], rtol=1e-5)


def test_console_scripts_import():
    """Every `[project.scripts]` target of the port imports, and the port's
    two scripts are there."""
    with open(ROOT / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    ours = {k: v for k, v in scripts.items() if v.startswith("deflicker_torch")}
    assert ours == {"deflicker-torch": "deflicker_torch.cli.main:main",
                    "deflicker-torch-batch": "deflicker_torch.cli.batch:main"}
    for target in ours.values():
        module, func = target.split(":")
        assert callable(getattr(importlib.import_module(module), func))
