"""Port vs JAX package: stage 2 of several videos in lockstep
(`refine_span_multi`, `FilterEngine.run_multi`) with the SHIPPED weights at
f32, and the batch CLI's group-parallel mode on the CPU."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deflicker_tpu.filter import convert as jconv
from deflicker_tpu.filter import engine as jeng

from deflicker_torch.filter import engine as teng
from deflicker_torch.models.refine import TransformNet
from deflicker_torch.utils.convert import load_stage2_module

torch.set_num_threads(2)

WEIGHTS = Path(__file__).resolve().parents[1] / "pretrained_weights"
FILTER = WEIGHTS / "neural_filter.ckpt"
LOCAL = WEIGHTS / "local_refinement_net.ckpt"


def test_refine_span_multi_matches_jax():
    """Two videos in one span, the second's last frame padding: per-video
    n_valid freezes only that video's carry.  Outputs and carries match the
    JAX package's (f32, atol 2e-4: conv summation order, as in
    test_torch_stage2)."""
    tnet = load_stage2_module(TransformNet(), LOCAL)
    lvars = jconv.load_stage2_checkpoint(LOCAL)
    rng = np.random.default_rng(0)
    preds = rng.uniform(0, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    p0 = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    nv = np.array([3, 2], np.int32)
    carry_j, out_j = jeng.refine_span_multi(
        lvars, (jnp.asarray(p0), jnp.asarray(p0)), jnp.asarray(preds),
        jnp.asarray(nv), dtype=jnp.float32)
    carry_t, out_t = teng.refine_span_multi(
        tnet, (torch.tensor(p0), torch.tensor(p0)), torch.tensor(preds), nv,
        torch.float32)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-4)
    for a, b in zip(carry_t, carry_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)
    np.testing.assert_array_equal(carry_t[1].numpy(),
                                  np.stack([preds[0, 2], preds[1, 1]]))


def test_run_multi_matches_jax_and_run(tmp_path):
    """`run_multi` over two videos of different lengths (3 and 4 frames,
    40x52, span 3 so one video ends on a span boundary) against the JAX
    package's `run_multi` (atol 2e-4) and against the port's own one-video
    `run` (atol 1e-5: the same convolutions on batches of another size);
    each video gets its full artifact set."""
    import cv2

    rng = np.random.default_rng(2)
    jobs = []
    for name, T in (("vid_a", 3), ("vid_b", 4)):
        cdir, sdir = tmp_path / name, tmp_path / (name + "_style")
        cdir.mkdir(), sdir.mkdir()
        for t in range(T):
            cv2.imwrite(str(cdir / f"{t:05d}.png"),
                        rng.uniform(0, 255, (40, 52, 3)).astype(np.uint8))
            cv2.imwrite(str(sdir / f"{t:05d}.png"),
                        rng.uniform(0, 255, (40, 52, 3)).astype(np.uint8))
        jobs.append((cdir, sdir, tmp_path / "port" / name))
    engine = teng.load_filter_engine(FILTER, LOCAL, device="cpu",
                                     dtype=torch.float32)
    engine.span = 3
    outs = engine.run_multi(jobs, fps=10)
    jengine = jeng.load_filter_engine(FILTER, LOCAL, dtype=jnp.float32)
    jengine.span = 3
    jouts = jengine.run_multi([(c, s, tmp_path / "jax" / c.name)
                               for c, s, _ in jobs], fps=10)
    assert [o.shape[0] for o in outs] == [3, 4]
    for (cdir, sdir, rdir), o, jo, T in zip(jobs, outs, jouts, (3, 4)):
        np.testing.assert_allclose(o, jo, atol=2e-4)
        single = engine.run(cdir, sdir, tmp_path / "single" / cdir.name, fps=10)
        np.testing.assert_allclose(o, single, atol=1e-5)
        assert len(sorted((rdir / "final" / "output").glob("*.png"))) == T
        assert len(sorted((rdir / "neural_filter" / "concat").glob("*.png"))) == T
        assert (rdir / "final" / "output.mp4").exists()
    with pytest.raises(ValueError, match="same-resolution"):
        bad = tmp_path / "small"
        bad.mkdir()
        cv2.imwrite(str(bad / "00000.png"), np.zeros((32, 32, 3), np.uint8))
        engine.run_multi([jobs[0], (bad, bad, tmp_path / "x")])


def test_batch_cli_parallel_fit(tmp_path):
    """`python -m deflicker_torch.cli.batch --parallel_fit` (its `main`, on
    the CPU): two same-shaped 4-frame clips fit as one V = 2 group (one
    chain launch per network and step: the plain twin here), a 5-frame clip
    past the cap of 4 goes through the chunked pipeline, and every video
    gets its stage-1 and final frames."""
    import cv2

    from deflicker_torch.cli import batch
    from deflicker_torch.config import AtlasConfig

    root = tmp_path / "data" / "test"
    rng = np.random.default_rng(1)
    for name, T in (("clip_a", 4), ("clip_b", 4), ("clip_long", 5)):
        frames = root / name
        frames.mkdir(parents=True)
        base = rng.uniform(40, 215, (32, 48 + T, 3))
        for t in range(T):
            frame = np.clip(base[:, t:t + 48] * (1.0 + 0.1 * (-1) ** t), 0, 255)
            cv2.imwrite(str(frames / f"{t:05d}.png"), frame.astype(np.uint8))
    cfg = dataclasses.replace(
        AtlasConfig(), samples_batch=64, pretrain_iter_number=1,
        maximum_number_of_frames=4, number_of_channels_atlas=16,
        number_of_layers_atlas=4, number_of_channels_mapping1=16,
        number_of_layers_mapping1=3, stop_global_rigidity=3)
    cfg_file = tmp_path / "tiny.json"
    cfg_file.write_text(json.dumps(cfg.to_reference_json()))
    rc = batch.main(["--videos", *(str(root / n) for n in
                                   ("clip_a", "clip_b", "clip_long")),
                     "--parallel_fit", "--iters", "6", "--down", "1",
                     "--root", str(root), "--results_root",
                     str(tmp_path / "results"), "--config", str(cfg_file),
                     "--ckpt_raft", str(tmp_path / "missing.pth"),
                     "--stage2_precision", "float32"], device="cpu")
    assert rc == 0
    for name, T in (("clip_a", 4), ("clip_b", 4), ("clip_long", 5)):
        res = tmp_path / "results" / name
        assert len(sorted((res / "stage_1" / "output").glob("*.png"))) == T, name
        assert len(sorted((res / "final" / "output").glob("*.png"))) == T, name
        assert (res / "stage_1" / "config.json").exists()
    assert list((tmp_path / "results" / "clip_long" / "stage_1").glob("chunk_*"))
