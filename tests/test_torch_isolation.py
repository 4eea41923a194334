"""The port stands alone: no JAX and nothing of the JAX package in
`deflicker_torch`, `chip_smoke.py` or the port's `tools/`, and no silent
CPU fallback."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deflicker_tpu")


def _port_sources():
    return (sorted((ROOT / "deflicker_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py")))


def test_no_forbidden_imports_in_sources():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    """Every module of the package, and chip_smoke, in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import deflicker_torch\n"
        "for m in pkgutil.walk_packages(deflicker_torch.__path__, 'deflicker_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Called without a device on a machine with no CUDA, entry points raise
    instead of running on the CPU."""
    from types import SimpleNamespace

    from deflicker_torch.atlas import render_from_texture
    from deflicker_torch.cli import batch
    from deflicker_torch.cli import convert_weights
    from deflicker_torch.cli import main as cli_main
    from deflicker_torch.cli import preprocess_flow
    from deflicker_torch.cli.evaluate import compute_video_metrics
    from deflicker_torch.cli.pipeline import run_pipeline
    from deflicker_torch.config import PipelineConfig
    from deflicker_torch.flow import RAFTFlow
    from deflicker_torch.metrics import warp_error_video
    from deflicker_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline(PipelineConfig(video_frame_folder=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main.main(["--video_frame_folder", str(tmp_path), "--gpu", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main.main(["--video_frame_folder", str(tmp_path), "--class_name",
                       "dog", "--mask_provider", "grabcut"])   # the dual path
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute_video_metrics(tmp_path, tmp_path)
    frames, flows = np.zeros((1, 4, 4, 3)), np.zeros((1, 4, 4, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warp_error_video(frames, frames, flows, flows)
    with pytest.raises(RuntimeError, match="no CUDA device"):   # a host uv
        render_from_texture(np.zeros((8, 8, 3), np.float32), 0.0, 1.0, 0.0,
                            1.0, np.full((5, 2), 0.5, np.float32))
    ckpt = tmp_path / "raft.pth"
    ckpt.write_bytes(b"")                 # found, and never read: no device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RAFTFlow()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RAFTFlow(ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess_flow.main(["--vid_name", "vid", "--root", str(tmp_path),
                              "--model", str(ckpt)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_weights.main(["--kind", "raft", "--src", str(ckpt),
                              "--dst", str(tmp_path / "out.ckpt")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.main(["--videos", str(tmp_path / "a.mp4"), "--parallel_fit"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.main(["--videos", str(tmp_path / "a.mp4")])      # sequential
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.run_batch_parallel([], SimpleNamespace(class_name=None,
                                                     results_root=str(tmp_path)),
                                 None)
    # the warm server and the per-stage CLIs
    from deflicker_torch import Deflickerer
    from deflicker_torch.cli import evaluate, serve, stage1, stage2

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Deflickerer().process(frame_folder=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--max_jobs", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage1.main(["--vid_name", "vid", "--root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage1.main(["--vid_name", "vid", "--root", str(tmp_path), "--class_name",
                     "dog", "--mask_provider", "grabcut"])   # the dual path
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage2.main(["--video_name", "vid", "--root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--video_name", "vid", "--root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_weights.main(["--kind", "filter", "--src", str(ckpt),
                              "--dst", str(tmp_path / "out.ckpt")])
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No CUDA device: non-zero exit and no result line, from the checkout
    and from a directory holding chip_smoke.py alone."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
