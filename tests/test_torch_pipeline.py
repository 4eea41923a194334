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
    """A long video now takes the chunked path (tests/test_torch_multifit.py);
    what the port still refuses: spreading a batch over hosts (--dcn), and
    resuming the chunked fit from a checkpoint that pickles classes other
    than numpy's and the two optax Adam states (here raw JAX arrays; a JAX
    group checkpoint written by the JAX package's save_checkpoint resumes,
    tests/test_torch_resume_jax.py)."""
    import pickle

    from deflicker_torch.cli import batch
    from deflicker_torch.cli.pipeline import run_stage1
    from deflicker_torch.config import AtlasConfig, PipelineConfig

    tmp, frames = tiny_video_dir
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        batch.main(["--videos", "a.mp4", "--dcn"], device="cpu")

    import optax

    results = tmp / "r"
    ckpt = results / "vid" / "stage_1" / "checkpoint"
    ckpt.parent.mkdir(parents=True)
    state = optax.adam(1e-3).init({"w": np.zeros((2, 3), np.float32)})
    ckpt.write_bytes(pickle.dumps({"opt_state_v": state, "iteration": 3}))
    cfg = PipelineConfig(video_frame_folder=str(frames), root=str(frames.parent),
                         results_root=str(results), down=2,
                         ckpt_raft=str(tmp / "missing.pth"))
    long_cfg = dataclasses.replace(AtlasConfig(), maximum_number_of_frames=3,
                                   load_checkpoint=True)
    with pytest.raises(pickle.UnpicklingError, match="jax._src.array"):
        run_stage1(frames, cfg, long_cfg, "cpu")


def test_run_stage1_dual_fits_four_networks(tiny_video_dir):
    """run_stage1(dual=True) no longer refuses: with `_seg` masks on disk it
    loads them, pretrains both mappings, fits mapping1, mapping2, atlas and
    alpha, and writes the texture set; the single-atlas run on the same
    seed draws the same init and pretrain streams as before (its own three
    generators), so its mapping1 checkpoint does not depend on the dual
    path's extra generator."""
    import cv2

    from deflicker_torch.cli.pipeline import _generators, run_stage1
    from deflicker_torch.config import AtlasConfig, PipelineConfig
    from deflicker_torch.utils.checkpoint import load_checkpoint

    tmp, frames = tiny_video_dir
    seg = frames.parent / "vid_seg"
    seg.mkdir()
    mask = np.zeros((48, 64), np.uint8)
    mask[10:30, 20:50] = 255
    for t in range(5):
        cv2.imwrite(str(seg / f"{t:05d}.png"), mask)
    cfg = PipelineConfig(video_frame_folder=str(frames), root=str(frames.parent),
                         results_root=str(tmp / "r"), down=2,
                         ckpt_raft=str(tmp / "missing.pth"))
    tiny = dataclasses.replace(
        AtlasConfig(), **dict(TINY, iters_num=12, evaluate_every=11,
                              stop_global_rigidity=4,
                              stop_bootstrapping_iteration=8),
        number_of_channels_alpha=32, number_of_layers_alpha=4,
        number_of_channels_mapping2=32, number_of_layers_mapping2=3)
    s1 = run_stage1(frames, cfg, tiny, "cpu", dual=True)
    assert s1["iterations"] == 12 and np.isfinite(s1["psnr"])
    assert s1["res"] == (24, 32)
    folder = tmp / "r" / "vid" / "stage_1"
    ck = load_checkpoint(folder / "checkpoint")
    assert ck["dual"] is True
    assert set(ck["params"]) == {"mapping1", "mapping2", "atlas", "alpha"}
    assert len(ck["params"]["mapping2"]) == 3 and len(ck["params"]["alpha"]) == 4
    assert ck["params"]["alpha"][-1]["w"].shape == (32, 1)
    for f in ("texture1.png", "texture2.png", "texture1_marked.png"):
        assert (folder / "texture" / f).exists(), f
    assert len(sorted((folder / "texture" / "alpha").glob("*.png"))) == 5
    # the second pretrain drives mapping2 (4 layers at the default, here 3)
    # towards uv = 0.8 * xy like the first
    from deflicker_torch.atlas import build_specs, pretrain_mapping
    from deflicker_torch.models.imlp import imlp_apply, imlp_init

    spec2 = build_specs(tiny, dual=True).mapping2
    p2 = imlp_init(spec2, torch.Generator().manual_seed(0))
    xyt = torch.rand((256, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1

    def err():
        with torch.no_grad():
            return float((imlp_apply(p2, xyt, spec2) - 0.8 * xyt[:, :2]).abs().mean())

    e0 = err()
    pretrain_mapping(p2, spec2, torch.Generator().manual_seed(2), 5, 24, 32,
                     0.8, pretrain_iters=40, batch=512, lr=1e-3)
    assert err() < 0.5 * e0
    # four generators, the first three seeded as the single-atlas run's
    gens = _generators(3, torch.device("cpu"))
    assert [g.initial_seed() for g in gens] == [3, 4, 5, 6]


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
