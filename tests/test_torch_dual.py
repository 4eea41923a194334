"""Port vs JAX package: the dual-atlas path — specs, the dual loss for every
schedule phase (same samples, same converted params), one Adam step, the
dual render, the fit's schedule, the stash switch, the checkpoint, and a
tiny dual pipeline run on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deflicker_tpu.atlas import data as jdata
from deflicker_tpu.atlas import engine as jeng
from deflicker_tpu.atlas import render as jrender
from deflicker_tpu.config import AtlasConfig as JAtlasConfig

from deflicker_torch.atlas import data as tdata
from deflicker_torch.atlas import engine as teng
from deflicker_torch.atlas import render as trender
from deflicker_torch.config import AtlasConfig
from deflicker_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from deflicker_torch.utils.convert import atlas_params_from_jax

torch.set_num_threads(2)

T, H, W = 4, 24, 32
NETS = ("mapping1", "mapping2", "atlas", "alpha")
NARROW = dict(number_of_channels_atlas=32, number_of_layers_atlas=8,
              number_of_channels_mapping1=32, number_of_layers_mapping1=4,
              number_of_channels_mapping2=32, number_of_layers_mapping2=3,
              number_of_channels_alpha=32, number_of_layers_alpha=4,
              positional_encoding_num_atlas=6, samples_batch=96,
              global_rigidity_derivative_amount_fg=5,
              global_rigidity_derivative_amount_bg=7,
              fit_precision="highest")


def _write_clip(root, T=T, H=H, W=W, seed=0):
    """Frames, a flow cache and `_seg` masks (a box that drifts right) in the
    reference's layout."""
    import cv2

    frames, flows, seg = root / "vid", root / "vid_flow", root / "vid_seg"
    for d in (frames, flows, seg):
        d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    base = rng.uniform(30, 220, (H, W + T, 3))
    for t in range(T):
        cv2.imwrite(str(frames / f"{t:05d}.png"),
                    base[:, t:t + W].astype(np.uint8))
        m = np.zeros((H, W), np.uint8)
        m[H // 4:H // 4 * 3, W // 4 + t:W // 2 + t] = 255
        cv2.imwrite(str(seg / f"{t:05d}.png"), m)
    for t in range(T - 1):
        f12 = np.zeros((H, W, 2), np.float32)
        f12[..., 0] = -1.0 + 0.3 * rng.normal(size=(H, W))
        f21 = -f12 + 0.8 * rng.normal(size=(H, W, 2)).astype(np.float32)
        np.save(flows / f"{t:05d}.png_{t + 1:05d}.png.npy", f12)
        np.save(flows / f"{t + 1:05d}.png_{t:05d}.png.npy", f21)
    return frames


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    frames = _write_clip(tmp_path_factory.mktemp("dual") / "data")
    cfg_t = dataclasses.replace(AtlasConfig(), **NARROW)
    cfg_j = dataclasses.replace(JAtlasConfig(), **NARROW)
    d_j = jdata.load_video_data(frames, H, W, 200, use_masks=True).with_packed()
    d_t = tdata.load_video_data(frames, H, W, 200, use_masks=True)
    specs_j = jeng.build_specs(cfg_j, dual=True)
    params = jeng.init_models(jax.random.key(0), specs_j)
    # the pretrained regime: a random mapping makes the rigidity Jacobian
    # near-singular and its gradients ill-conditioned for any comparison
    for k, net in enumerate(("mapping1", "mapping2")):
        params[net] = jeng.pretrain_mapping(
            params[net], getattr(specs_j, net), jax.random.key(1 + k), T, H, W,
            cfg_j.uv_mapping_scale, pretrain_iters=30, batch=512)
    host = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(3)
    jif = (rng.integers(0, W, 96), rng.integers(0, H, 96),
           rng.integers(0, T, 96))
    return cfg_j, cfg_t, d_j, d_t, specs_j, params, host, jif


def test_dual_specs_match_jax():
    """mapping2 4x256 without encoding, alpha 8x256 with PE 5 and one output,
    field by field as the JAX package builds them; `.dual` follows."""
    s_j = jeng.build_specs(JAtlasConfig(), dual=True)
    s_t = teng.build_specs(AtlasConfig(), dual=True)
    assert s_t.dual and not teng.build_specs(AtlasConfig()).dual
    for net in NETS:
        assert dataclasses.asdict(getattr(s_t, net)) == dataclasses.asdict(
            getattr(s_j, net)), net
    assert s_t.mapping2.layer_dims()[0] == (3, 256) and s_t.mapping2.num_layers == 4
    assert s_t.alpha.layer_dims()[0] == (30, 256)
    assert s_t.alpha.layer_dims()[-1] == (256, 1)
    p = teng.init_models(s_t, torch.Generator().manual_seed(0))
    assert set(p) == set(NETS)
    # the single-atlas draws do not depend on the dual flag
    p1 = teng.init_models(teng.build_specs(AtlasConfig()),
                          torch.Generator().manual_seed(0))
    assert torch.equal(p["atlas"][3]["w"], p1["atlas"][3]["w"])


def test_load_video_data_with_masks_matches(setup):
    _, _, d_j, d_t, *_ = setup
    np.testing.assert_array_equal(d_t.mask, np.asarray(d_j.mask))
    assert 0 < d_t.mask.mean() < 1
    np.testing.assert_array_equal(d_t.with_packed().packed.numpy(),
                                  np.asarray(d_j.packed))


@pytest.mark.parametrize("include_bootstrap", [True, False])
@pytest.mark.parametrize("include_global", [True, False])
def test_dual_loss_and_grads_match(setup, include_global, include_bootstrap):
    """Same (j, i, f) samples and converted params through both dual loss
    functions at fit_precision="highest" (plain f32 on both sides): the
    total and every aux term (rtol 1e-4: f32 summation order) and every
    parameter gradient of the four networks (relative Frobenius 1e-3: the
    rigidity inverse amplifies rounding, see test_torch_losses)."""
    cfg_j, cfg_t, d_j, d_t, specs_j, params, host, (j, i, f) = setup
    lf_j = jeng.make_loss_fn(specs_j, cfg_j, d_j, include_global,
                             include_bootstrap)
    (tot_j, aux_j), g_j = jax.value_and_grad(lf_j, has_aux=True)(
        params, d_j, jnp.asarray(j), jnp.asarray(i), jnp.asarray(f))

    specs_t = teng.build_specs(cfg_t, dual=True)
    p_t = atlas_params_from_jax(host)
    assert set(p_t) == set(NETS)
    lf_t = teng.make_loss_fn(specs_t, cfg_t, d_t, include_global,
                             include_bootstrap)
    tot_t, aux_t = lf_t(p_t, d_t.with_packed().packed, torch.tensor(j),
                        torch.tensor(i), torch.tensor(f))
    tot_t.backward()
    assert set(aux_t) == set(aux_j)
    assert ("global_rigidity2" in aux_t) == include_global
    assert ("alpha_bootstrap" in aux_t) == include_bootstrap
    for k in aux_j:
        np.testing.assert_allclose(aux_t[k].item(), float(aux_j[k]),
                                   rtol=1e-4, err_msg=k)
    for net in NETS:
        for lt, lj in zip(p_t[net], g_j[net]):
            for key in ("w", "b"):
                a, b = lt[key].grad.numpy(), np.asarray(lj[key])
                rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
                assert rel < 1e-3, (net, key, rel)


def test_dual_one_adam_step_matches(setup):
    """optax.adam and the port's Adam from the same dual params and each
    package's own gradients: params agree to 2e-6 absolute after one step
    (the step is lr * g/|g| where |g| > eps)."""
    cfg_j, cfg_t, d_j, d_t, specs_j, params, host, (j, i, f) = setup
    lf_j = jeng.make_loss_fn(specs_j, cfg_j, d_j, True, True)
    g_j = jax.grad(lambda p: lf_j(p, d_j, jnp.asarray(j), jnp.asarray(i),
                                  jnp.asarray(f))[0])(params)
    opt = optax.adam(cfg_j.learning_rate)
    upd, _ = opt.update(g_j, opt.init(params), params)
    new_j = optax.apply_updates(params, upd)

    specs_t = teng.build_specs(cfg_t, dual=True)
    p_t = atlas_params_from_jax(host)
    lf_t = teng.make_loss_fn(specs_t, cfg_t, d_t, True, True)
    o_t = teng.make_optimizer(p_t, cfg_t.learning_rate)
    lf_t(p_t, d_t.with_packed().packed, torch.tensor(j), torch.tensor(i),
         torch.tensor(f))[0].backward()
    o_t.step()
    for net in NETS:
        for lt, lj in zip(p_t[net], new_j[net]):
            for key in ("w", "b"):
                np.testing.assert_allclose(lt[key].detach().numpy(),
                                           np.asarray(lj[key]), atol=2e-6)


def test_dual_render_frame_matches(setup):
    """render_frame on the dual models: rgb (the alpha blend), alpha, uv1
    and uv2 of a frame equal the JAX render to f32 rounding (atol 2e-5 on
    values in [-1, 1]); render_frames stacks the same rgb."""
    cfg_j, cfg_t, _, _, specs_j, params, host, _ = setup
    specs_t = teng.build_specs(cfg_t, dual=True)
    p_t = atlas_params_from_jax(host)
    out_j = jrender.render_frame(params, specs_j, 2, H, W, T)
    out_t = trender.render_frame(p_t, specs_t, 2, H, W, T)
    assert set(out_t) == {"rgb", "uv1", "alpha", "uv2"}
    assert out_t["alpha"].shape == (H, W, 1) and out_t["uv2"].shape == (H, W, 2)
    for k in out_t:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=2e-5, err_msg=k)
    a = out_t["alpha"].numpy()
    assert 0.001 <= a.min() and a.max() <= 0.991
    all_t = trender.render_frames(p_t, specs_t, T, H, W, rows_per_call=2 * H * W)
    np.testing.assert_array_equal(all_t[2], out_t["rgb"].numpy())
    # a single-atlas render of the same mapping1 / atlas has no alpha
    single = trender.render_frame(p_t, teng.build_specs(cfg_t), 2, H, W, T)
    assert set(single) == {"rgb", "uv1"}
    assert np.abs(single["rgb"].numpy() - all_t[2]).max() > 1e-3


def test_dual_fit_schedule_and_terms(setup):
    """Chunks end at both schedule boundaries: global rigidity (both
    mappings) stops after iteration 4, alpha bootstrapping after 8; every
    logged term is finite and all four networks move."""
    _, cfg_t, _, d_t, _, _, host, _ = setup
    cfg = dataclasses.replace(cfg_t, iters_num=12, steps_per_call=20,
                              stop_global_rigidity=4,
                              stop_bootstrapping_iteration=8,
                              evaluate_every=100, fit_precision="default")
    specs = teng.build_specs(cfg, dual=True)
    p = atlas_params_from_jax(host)
    before = {n: p[n][0]["w"].detach().clone() for n in NETS}
    res = teng.fit_atlas(p, specs, d_t, cfg, torch.Generator().manual_seed(0))
    assert [r["iteration"] for r in res.logs] == [4, 8, 11]
    dual_terms = {"rigidity2", "flow2", "sparsity", "alpha_flow"}
    assert dual_terms <= set(res.logs[0])
    assert {"global_rigidity1", "global_rigidity2", "alpha_bootstrap"} <= set(res.logs[0])
    assert "global_rigidity2" not in res.logs[1] and "alpha_bootstrap" in res.logs[1]
    assert "alpha_bootstrap" not in res.logs[2] and dual_terms <= set(res.logs[2])
    for r in res.logs:
        assert all(np.isfinite(v) for v in r.values()), r
    for n in NETS:
        assert not torch.equal(before[n], p[n][0]["w"].detach()), n
    assert res.opt_state["step"] == 12
    assert len(res.opt_state["exp_avg"]) == len(teng.flat_params(p))


def test_stash_switch_selects_the_stash_pair(setup, monkeypatch):
    """DEFLICKER_IMLP_STASH=1 (the JAX package's switch) routes the fit's
    four networks through the stash pair: `select_imlp_apply` passes
    stash_bwd=True, and on the CPU (plain twins) a short dual fit ends
    bit-equal to the remat fit, as the kernels' contract says."""
    from deflicker_torch.models.imlp import imlp_apply, imlp_apply_fused

    _, cfg_t, _, d_t, _, _, host, _ = setup
    cfg = dataclasses.replace(cfg_t, iters_num=4, steps_per_call=4,
                              evaluate_every=100, fit_precision="default")
    specs = teng.build_specs(cfg, dual=True)

    def fit():
        p = atlas_params_from_jax(host)
        teng.fit_atlas(p, specs, d_t, cfg, torch.Generator().manual_seed(5))
        return p

    monkeypatch.delenv("DEFLICKER_IMLP_STASH", raising=False)
    assert teng.select_imlp_apply(True, "default") is imlp_apply_fused
    remat = fit()
    monkeypatch.setenv("DEFLICKER_IMLP_STASH", "1")
    picked = teng.select_imlp_apply(True, "default")
    assert picked.func is imlp_apply_fused and picked.keywords == {"stash_bwd": True}
    assert teng.select_imlp_apply(True, "highest") is imlp_apply
    stash = fit()
    for n in NETS:
        for a, b in zip(remat[n], stash[n]):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    monkeypatch.setenv("DEFLICKER_IMLP_STASH", "0")
    assert teng.select_imlp_apply(True, "default") is imlp_apply_fused


def test_dual_checkpoint_round_trip(setup, tmp_path):
    """A dual checkpoint carries all four networks and the dual flag through
    save -> load -> atlas_params_from_jax."""
    _, cfg_t, _, d_t, _, _, host, _ = setup
    cfg = dataclasses.replace(cfg_t, save_diagnostics=False)
    specs = teng.build_specs(cfg, dual=True)
    p = atlas_params_from_jax(host)
    trender.evaluate_and_save(p, specs, d_t, cfg, tmp_path, 7, None)
    ck = load_checkpoint(tmp_path / "checkpoint")
    assert ck["dual"] is True and ck["iteration"] == 7
    assert set(ck["params"]) == set(NETS)
    back = atlas_params_from_jax(ck["params"])
    for n in NETS:
        assert len(back[n]) == len(p[n])
        for a, b in zip(back[n], p[n]):
            assert torch.equal(a["w"], b["w"].detach()) and a["w"].requires_grad
    assert len(sorted((tmp_path / "output").glob("*.png"))) == T


@pytest.mark.parametrize("dual", [False, True])
def test_save_diagnostics_writes_the_video_set(setup, tmp_path, dual):
    """save_diagnostics no longer raises: evaluate_and_save writes the
    residual / uv / per-pixel-loss videos, the alpha set on the dual path,
    and the matplotlib global_info panels; the maps have the frame's shape
    and are finite."""
    _, cfg_t, _, d_t, _, _, host, _ = setup
    cfg = dataclasses.replace(cfg_t, save_diagnostics=True)
    specs = teng.build_specs(cfg, dual=dual)
    p = atlas_params_from_jax(host)
    diag = trender.render_diagnostics(p, specs, d_t, 1, cfg)
    assert diag["rgb"].shape == (H, W, 3) and diag["rigidity_map"].shape == (H, W)
    assert ("alpha" in diag) == dual and ("uv2" in diag) == dual
    assert all(torch.isfinite(v).all() for v in diag.values())
    assert float(diag["flow_map"].max()) > 0
    trender.evaluate_and_save(p, specs, d_t, cfg, tmp_path, 0, None)
    names = ["residuals", "uv_1", "rigidity_loss", "flow_loss", "rgb_error",
             "global_info"]
    dual_names = ["alpha", "alpha_vs_mask", "uv_2", "uv_1_masked"]
    for n in names + (dual_names if dual else []):
        assert (tmp_path / f"{n}.mp4").stat().st_size > 0, n
    if not dual:
        assert not (tmp_path / "alpha.mp4").exists()


def test_render_diagnostics_match_jax(setup):
    """The per-pixel diagnostic maps of a dual frame equal the JAX
    package's: rgb, residual, uv, alpha to 2e-5 absolute; the flow map to
    1e-3 relative (a norm scaled by L / 2s); the rigidity map to 1e-2
    relative (its inverse-Jacobian term amplifies f32 rounding)."""
    cfg_j, cfg_t, d_j, d_t, specs_j, params, host, _ = setup
    specs_t = teng.build_specs(cfg_t, dual=True)
    d_j = jax.tree_util.tree_map(jnp.asarray, d_j)
    out_j = jrender.render_diagnostics(params, specs_j, d_j, 1, cfg_j)
    out_t = trender.render_diagnostics(atlas_params_from_jax(host), specs_t,
                                       d_t, 1, cfg_t)
    assert set(out_t) == set(out_j)
    for k in ("rgb", "residual", "uv1", "uv2", "alpha", "rgb_error_map"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=2e-5, err_msg=k)
    np.testing.assert_allclose(out_t["flow_map"].numpy(),
                               np.asarray(out_j["flow_map"]), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out_t["rigidity_map"].numpy(),
                               np.asarray(out_j["rigidity_map"]), rtol=1e-2)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

TINY = dict(iters_num=60, samples_batch=128, steps_per_call=10,
            evaluate_every=59, pretrain_iter_number=2,
            number_of_channels_atlas=32, number_of_layers_atlas=4,
            number_of_channels_alpha=32, number_of_layers_alpha=4,
            number_of_channels_mapping1=32, number_of_layers_mapping1=3,
            number_of_channels_mapping2=32, number_of_layers_mapping2=3,
            stop_global_rigidity=20, stop_bootstrapping_iteration=40)


@pytest.fixture
def tiny_dual_dir(tmp_path):
    """A 5-frame 48x64 flickering clip with `_seg` masks on disk."""
    import cv2

    frames = tmp_path / "data" / "test" / "vid"
    seg = frames.parent / "vid_seg"
    frames.mkdir(parents=True)
    seg.mkdir()
    rng = np.random.default_rng(0)
    base = rng.uniform(40, 215, (48, 64, 3)).astype(np.uint8)
    mask = np.zeros((48, 64), np.uint8)
    mask[10:30, 20:50] = 255
    for t in range(5):
        frame = np.roll(base, t, axis=1).astype(np.float32)
        frame = np.clip(frame * (1.0 + 0.1 * ((-1) ** t)), 0, 255)  # flicker
        cv2.imwrite(str(frames / f"{t:05d}.png"), frame.astype(np.uint8))
        cv2.imwrite(str(seg / f"{t:05d}.png"), np.roll(mask, t, axis=1))
    return tmp_path, frames


def test_dual_pipeline_artifacts_and_psnr_vs_jax(tiny_dual_dir):
    """run_pipeline(device="cpu") with class_name set and `_seg` files on
    disk: the mask provider reuses the files, stage 1 fits four networks and
    writes the dual artifact set (textures, alpha maps), stage 2 and the
    metrics run.  Both packages start from the same converted init (the JAX
    init and pretrains, handed over through load_checkpoint) on the same
    frames, masks and Farneback flow; their sample streams differ, so the
    outcome is compared: stage-1 PSNR within 0.08 dB.  Measured on this
    clip: 13.4636 (port) vs 13.4640 dB (JAX), while the init alone renders
    at 13.153 dB — the band is a quarter of what the 60 steps gain."""
    from deflicker_tpu.cli import pipeline as jpipe
    from deflicker_tpu.config import PipelineConfig as JPipelineConfig
    from deflicker_torch.cli.pipeline import run_pipeline
    from deflicker_torch.config import PipelineConfig

    tmp, frames = tiny_dual_dir
    seg_before = {p.name: p.stat().st_mtime_ns
                  for p in (frames.parent / "vid_seg").glob("*.png")}
    cfg_j = dataclasses.replace(JAtlasConfig(), **TINY)
    specs = jeng.build_specs(cfg_j, dual=True)
    params = jeng.init_models(jax.random.key(0), specs)
    for k, net in enumerate(("mapping1", "mapping2")):
        params[net] = jeng.pretrain_mapping(
            params[net], getattr(specs, net), jax.random.key(1 + k), 5, 48, 64,
            cfg_j.uv_mapping_scale, pretrain_iters=20, batch=1024)
    init = save_checkpoint(tmp / "init.ckpt", {
        "params": jax.tree_util.tree_map(np.asarray, params),
        "opt_state": None, "iteration": 0})
    resume = dict(load_checkpoint=True, checkpoint_path=str(init))

    common = dict(video_frame_folder=str(frames), root=str(frames.parent),
                  class_name="anything", mask_provider="grabcut",
                  ckpt_raft=str(tmp / "missing.pth"))
    out = run_pipeline(
        PipelineConfig(**common, results_root=str(tmp / "results"),
                       ckpt_filter="neural_filter.pth",
                       ckpt_local="local_refinement_net.pth"),
        dataclasses.replace(AtlasConfig(), **TINY, **resume), device="cpu")
    assert out["res"] == (48, 64)               # the dual default: down = 1
    assert out["iterations"] == 60
    for k in ("psnr", "final_psnr", "final_ewarp", "input_ewarp"):
        assert np.isfinite(out[k]), k
    seg_after = {p.name: p.stat().st_mtime_ns
                 for p in (frames.parent / "vid_seg").glob("*.png")}
    assert seg_after == seg_before              # masks reused, not rewritten

    results = tmp / "results" / "vid"
    s1 = results / "stage_1"
    assert len(sorted((s1 / "output").glob("*.png"))) == 5
    for f in ("checkpoint", "config.json", "scalars.jsonl",
              "reconstruction.mp4", "texture/texture1.png",
              "texture/texture1_marked.png", "texture/texture2.png",
              "texture/texture2_marked.png"):
        assert (s1 / f).exists(), f
    assert len(sorted((s1 / "texture" / "alpha").glob("*.png"))) == 5
    ck = load_checkpoint(s1 / "checkpoint")
    assert ck["dual"] is True and set(ck["params"]) == set(NETS)
    for sub in ("neural_filter/output", "final/output"):
        assert len(sorted((results / sub).glob("*.png"))) == 5, sub
    import json

    terms = set()
    for line in (s1 / "scalars.jsonl").read_text().splitlines():
        terms |= set(json.loads(line))
    assert {"sparsity", "alpha_flow", "alpha_bootstrap", "flow2",
            "global_rigidity2"} <= terms

    s_j = jpipe.run_stage1(frames, JPipelineConfig(**common),
                           dataclasses.replace(cfg_j, **resume), dual=True,
                           results_root=tmp / "jax")
    assert abs(out["psnr"] - s_j["psnr"]) < 0.08, (out["psnr"], s_j["psnr"])
