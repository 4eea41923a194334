"""The port's pipeline end to end on the CPU (device="cpu"), and a whole
stage-1 fit of both packages from the same converted init."""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

TINY = dict(iters_num=30, samples_batch=128, steps_per_call=10,
            evaluate_every=29, pretrain_iter_number=2,
            number_of_channels_atlas=32, number_of_layers_atlas=4,
            number_of_channels_mapping1=32, number_of_layers_mapping1=3,
            stop_global_rigidity=15)


@pytest.fixture
def tiny_video_dir(tmp_path):
    """The 5-frame 48x64 flickering clip of tests/test_pipeline.py."""
    import cv2

    root = tmp_path / "data" / "test"
    frames = root / "vid"
    frames.mkdir(parents=True)
    rng = np.random.default_rng(0)
    base = rng.uniform(40, 215, (48, 64, 3)).astype(np.uint8)
    for t in range(5):
        frame = np.roll(base, t, axis=1).astype(np.float32)
        frame = np.clip(frame * (1.0 + 0.1 * ((-1) ** t)), 0, 255)  # flicker
        cv2.imwrite(str(frames / f"{t:05d}.png"), frame.astype(np.uint8))
    return tmp_path, frames


def test_full_pipeline_artifacts(tiny_video_dir):
    """run_pipeline(device="cpu") at tiny widths with the shipped stage-2
    weights writes the whole artifact tree and finite metrics."""
    from deflicker_torch.cli.pipeline import run_pipeline
    from deflicker_torch.config import AtlasConfig, PipelineConfig

    tmp, frames = tiny_video_dir
    cfg = PipelineConfig(
        video_frame_folder=str(frames), root=str(frames.parent),
        results_root=str(tmp / "results"), down=2,
        ckpt_raft=str(tmp / "missing.pth"),
        ckpt_filter="neural_filter.pth", ckpt_local="local_refinement_net.pth")
    out = run_pipeline(cfg, dataclasses.replace(AtlasConfig(), **TINY),
                       device="cpu")
    assert np.isfinite(out["psnr"]) and out["psnr"] > 0
    for k in ("final_psnr", "final_ewarp", "input_ewarp"):
        assert np.isfinite(out[k]), k
    assert out["iterations"] == 30

    results = tmp / "results" / "vid"
    assert len(sorted((results / "stage_1" / "output").glob("*.png"))) == 5
    assert list((results / "stage_1").glob("PSNR_*"))
    for f in ("checkpoint", "config.json", "scalars.jsonl",
              "reconstruction.mp4", "input_video.mp4"):
        assert (results / "stage_1" / f).exists(), f
    for sub in ("neural_filter/concat", "neural_filter/output", "final/output"):
        assert len(sorted((results / sub).glob("*.png"))) == 5, sub
        assert (results / (sub + ".mp4")).exists()
    import cv2

    final = cv2.imread(str(results / "final" / "output" / "00000.png"))
    assert final.shape == (48, 64, 3)          # exact crop of the /32 padding


def _random_raft_pth(path, seed=0):
    """A seeded random RAFT saved as `raft-things.pth` is: reference keys
    under the DataParallel `module.` prefix."""
    from deflicker_torch.models.raft import raft_init

    model = raft_init(torch.Generator().manual_seed(seed))
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, path)
    return path


def test_pipeline_takes_raft_when_its_checkpoint_exists(tiny_video_dir):
    """With a RAFT checkpoint on disk `make_flow_provider` returns RAFTFlow
    on the pipeline's device (found at the given path or beside it as
    `.pth`), and stage 1 on the CPU writes RAFT's flow cache through the
    batched branch before the fit.  Two GRU iterations keep it short."""
    from deflicker_torch.cli.pipeline import make_flow_provider, run_stage1
    from deflicker_torch.config import AtlasConfig, PipelineConfig
    from deflicker_torch.flow import FarnebackFlow, RAFTFlow

    tmp, frames = tiny_video_dir
    _random_raft_pth(tmp / "raft-things.pth")
    cfg = PipelineConfig(video_frame_folder=str(frames), root=str(frames.parent),
                         results_root=str(tmp / "results"), down=2,
                         ckpt_raft=str(tmp / "raft-things.ckpt"))
    provider = make_flow_provider(cfg, "cpu")
    assert isinstance(provider, RAFTFlow)
    assert provider.device.type == "cpu" and provider.iters == 20
    assert provider.dtype == torch.bfloat16 and provider.corr_mode == "auto"
    assert isinstance(make_flow_provider(
        PipelineConfig(ckpt_raft=str(tmp / "none.pth")), "cpu"), FarnebackFlow)

    provider.iters = 2
    calls = []
    compute_batch = provider.compute_batch
    provider.compute_batch = lambda a, b: calls.append(len(a)) or compute_batch(a, b)
    s1 = run_stage1(frames, cfg, dataclasses.replace(AtlasConfig(), **TINY),
                    "cpu", flow_provider=provider)
    assert calls == [8]                       # 4 pairs x 2 directions, one batch
    flows = sorted((frames.parent / "vid_flow").glob("*.npy"))
    assert len(flows) == 8
    for f in flows:
        flow = np.load(f)
        assert flow.shape == (48, 64, 2) and flow.dtype == np.float32
        assert np.isfinite(flow).all()
    assert np.isfinite(s1["psnr"]) and s1["t_flow"] > 0


def test_refuses_what_the_slice_does_not_port(tiny_video_dir):
    from deflicker_torch.cli.pipeline import run_stage1
    from deflicker_torch.config import AtlasConfig, PipelineConfig

    tmp, frames = tiny_video_dir
    cfg = PipelineConfig(video_frame_folder=str(frames), root=str(frames.parent),
                         results_root=str(tmp / "r"), down=2,
                         ckpt_raft=str(tmp / "missing.pth"))
    long_cfg = dataclasses.replace(AtlasConfig(), maximum_number_of_frames=3)
    with pytest.raises(NotImplementedError, match="not truncated"):
        run_stage1(frames, cfg, long_cfg, "cpu")
    with pytest.raises(NotImplementedError, match="dual-atlas"):
        run_stage1(frames, cfg, AtlasConfig(), "cpu", dual=True)


def test_stage1_fit_tracks_jax_from_same_init(tiny_video_dir):
    """Both packages fit stage 1 from the same converted init (the JAX
    init + pretrain, handed to each through its load_checkpoint path) on the
    same frames and the same Farneback flow cache.  Their sample streams
    differ, so only the outcome is compared: stage-1 PSNR within 0.3 dB.
    Measured on this clip: 18.557 (port) vs 18.555 dB (JAX), while the init
    alone renders at 17.42 dB — the band is a quarter of what the fit
    gains."""
    import jax

    from deflicker_tpu.atlas import engine as jeng
    from deflicker_tpu.cli import pipeline as jpipe
    from deflicker_tpu.config import AtlasConfig as JAtlasConfig
    from deflicker_tpu.config import PipelineConfig as JPipelineConfig
    from deflicker_torch.cli import pipeline as tpipe
    from deflicker_torch.config import AtlasConfig, PipelineConfig
    from deflicker_torch.utils.checkpoint import save_checkpoint

    tmp, frames = tiny_video_dir
    tiny = dict(TINY, iters_num=80, evaluate_every=79, stop_global_rigidity=40)
    cfg_j = dataclasses.replace(JAtlasConfig(), **tiny)
    specs = jeng.build_specs(cfg_j, dual=False)
    params = jeng.init_models(jax.random.key(0), specs)
    params["mapping1"] = jeng.pretrain_mapping(
        params["mapping1"], specs.mapping1, jax.random.key(1), 5, 24, 32,
        cfg_j.uv_mapping_scale, pretrain_iters=20, batch=1024)
    init = save_checkpoint(tmp / "init.ckpt", {
        "params": jax.tree_util.tree_map(np.asarray, params),
        "opt_state": None, "iteration": 0})

    resume = dict(load_checkpoint=True, checkpoint_path=str(init))
    common = dict(video_frame_folder=str(frames), root=str(frames.parent),
                  down=2, ckpt_raft=str(tmp / "missing.pth"))
    s_j = jpipe.run_stage1(frames, JPipelineConfig(**common), dataclasses.replace(
        cfg_j, **resume), dual=False, results_root=tmp / "jax")
    s_t = tpipe.run_stage1(frames, PipelineConfig(**common), dataclasses.replace(
        AtlasConfig(), **tiny, **resume), "cpu", results_root=tmp / "torch")
    assert s_t["iterations"] == 80
    assert abs(s_t["psnr"] - s_j["psnr"]) < 0.3, (s_t["psnr"], s_j["psnr"])
