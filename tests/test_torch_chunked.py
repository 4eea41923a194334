"""Port vs JAX package: the chunked long-video path on the CPU.  A 7-frame
clip with maximum_number_of_frames 3 splits into 3 chunks of 3 (starts 0, 3,
4: the last anchored backward), fit at once as one group; both packages
must write every frame once with continuous numbering, and land their
stage-1 PSNR close together (the fits draw from different generators, so
PSNR, not params, is compared), single and dual."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from deflicker_tpu.cli import pipeline as jpipe
from deflicker_tpu.config import AtlasConfig as JAtlasConfig

from deflicker_torch.config import AtlasConfig, PipelineConfig

torch.set_num_threads(2)

T_ALL, H, W = 7, 24, 32
TINY = dict(iters_num=6, samples_batch=64, steps_per_call=6, evaluate_every=5,
            pretrain_iter_number=1, maximum_number_of_frames=3,
            number_of_channels_atlas=16, number_of_layers_atlas=4,
            number_of_channels_mapping1=16, number_of_layers_mapping1=3,
            number_of_channels_mapping2=16, number_of_layers_mapping2=3,
            number_of_channels_alpha=16, number_of_layers_alpha=3,
            stop_global_rigidity=3, stop_bootstrapping_iteration=3)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A drifting texture with per-frame flicker and a drifting box mask."""
    import cv2

    root = tmp_path_factory.mktemp("chunked") / "data"
    frames, seg = root / "vid", root / "vid_seg"
    frames.mkdir(parents=True)
    seg.mkdir()
    rng = np.random.default_rng(0)
    base = rng.uniform(40, 215, (H, W + T_ALL, 3))
    for t in range(T_ALL):
        frame = np.clip(base[:, t:t + W] * (1.0 + 0.1 * (-1) ** t), 0, 255)
        cv2.imwrite(str(frames / f"{t:05d}.png"), frame.astype(np.uint8))
        m = np.zeros((H, W), np.uint8)
        m[6:18, 8 + t:16 + t] = 255
        cv2.imwrite(str(seg / f"{t:05d}.png"), m)
    return root, frames


@pytest.mark.parametrize("dual", [False, True])
def test_chunked_stage1_matches_jax(clip, dual):
    """The port's `run_stage1` on a video past the cap (its flow cache is
    then read by the JAX package's `_run_stage1_chunked` as well): 3 chunks,
    7 frames written as 00000..00006, the PSNR marker, the group checkpoint
    with the generator state, per-chunk input videos and, on the dual path,
    per-chunk textures; stage-1 PSNR within 1.5 dB of the JAX package's."""
    from deflicker_torch.cli.pipeline import run_stage1
    from deflicker_torch.utils.checkpoint import load_checkpoint

    root, frames = clip
    cfg = PipelineConfig(video_frame_folder=str(frames), root=str(root),
                         results_root=str(root / f"port{dual}"), down=1,
                         ckpt_raft=str(root / "missing.pth"))
    s1 = run_stage1(frames, cfg, dataclasses.replace(AtlasConfig(), **TINY),
                    "cpu", dual=dual)
    j1 = jpipe._run_stage1_chunked(
        frames, dataclasses.replace(JAtlasConfig(), **TINY), dual, H, W,
        root / f"jax{dual}")
    assert s1["chunks"] == j1["chunks"] == 3
    assert s1["num_frames"] == j1["num_frames"] == T_ALL
    assert s1["iterations"] == 6
    folder = root / f"port{dual}" / "vid" / "stage_1"
    names = sorted(p.name for p in (folder / "output").glob("*.png"))
    want = sorted(p.name for p in (root / f"jax{dual}" / "output").glob("*.png"))
    assert names == want == [f"{t:05d}.png" for t in range(T_ALL)]
    assert len(list(folder.glob("PSNR_*"))) == 1
    assert (folder / "reconstruction.mp4").exists()
    for k in range(3):
        assert (folder / f"chunk_{k:02d}" / "input_video.mp4").exists()
        assert (folder / "texture" / f"chunk_{k:02d}" / "texture1.png").exists() \
            == dual
    ck = load_checkpoint(folder / "checkpoint")
    assert ck["chunk_starts"] == [0, 3, 4] and ck["chunk_size"] == 3
    assert ck["iteration"] == 6 and ck["params_v"]["atlas"][0]["w"].shape[0] == 3
    assert ck["generator_state"].dtype == np.uint8
    assert np.isfinite(s1["psnr"]) and abs(s1["psnr"] - j1["psnr"]) < 1.5, (
        s1["psnr"], j1["psnr"])


def test_chunked_pipeline_end_to_end(clip):
    """`run_pipeline` past the cap: stage 2 refines all 7 frames in one
    unbroken recurrence, the metrics are finite, and a second run with
    `load_checkpoint` resumes the group fit from the checkpoint (iteration
    6 of 6: nothing left to fit) instead of starting again."""
    from deflicker_torch.cli.pipeline import run_pipeline

    root, frames = clip
    cfg = PipelineConfig(video_frame_folder=str(frames), root=str(root),
                         results_root=str(root / "e2e"), down=1,
                         ckpt_raft=str(root / "missing.pth"),
                         ckpt_filter="neural_filter.pth",
                         ckpt_local="local_refinement_net.pth")
    atlas_cfg = dataclasses.replace(AtlasConfig(), **TINY)
    out = run_pipeline(cfg, atlas_cfg, device="cpu")
    assert out["chunks"] == 3 and out["num_frames"] == T_ALL
    for k in ("psnr", "final_psnr", "final_ewarp"):
        assert np.isfinite(out[k]), k
    final = sorted(p.name for p in (root / "e2e" / "vid" / "final" / "output")
                   .glob("*.png"))
    assert final == [f"{t:05d}.png" for t in range(T_ALL)]
    again = run_pipeline(cfg, dataclasses.replace(atlas_cfg, load_checkpoint=True),
                         device="cpu")
    assert again["iterations"] == 0 and again["chunks"] == 3
    assert np.isfinite(again["psnr"])
