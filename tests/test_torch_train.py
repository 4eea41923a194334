"""Port vs JAX package: stage-2 training (`train/synth.py`,
`train/stage2_trainer.py`, `cli/train_stage2.py`).

The clip builds take the JAX package's own draws (its key tree rebuilt from
`deflicker_tpu/train/synth.py` through its own helpers) and must give the
JAX clips; the trainer's steps take the JAX chunks' own clips from one init
and must give their losses and parameters; a port-trained checkpoint must
compute the same in the JAX package.  The JAX side runs under
`jax.default_matmul_precision("highest")`: this JAX build's CPU matmuls
are low-precision by default, and the texture phases (~200 rad) turn that
into O(1) errors.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflicker_tpu.filter import engine as jeng
from deflicker_tpu.models.refine import transformnet_init as j_tnet_init
from deflicker_tpu.models.unet import unet_init as j_unet_init
from deflicker_tpu.train import stage2_trainer as jtrain
from deflicker_tpu.train import synth as jsynth

from deflicker_torch.filter import engine as teng
from deflicker_torch.models import TransformNet, UNet
from deflicker_torch.ops.sampling import flow_warp
from deflicker_torch.train import stage2_trainer as ptrain
from deflicker_torch.train import synth as psynth
from deflicker_torch.utils.convert import stage2_from_flax

torch.set_num_threads(2)

T, H, W = 5, 40, 56
TEX_HW = (112, 136)
CLIP_ATOL = 2e-4          # f32 builds: 2-term products and K-term sums
VALID_BAND = 1e-3         # share of pixels whose valid may flip at a threshold


def _highest():
    return jax.default_matmul_precision("highest")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))[None]


def _tex(params):
    return psynth.Texture(*(_t(a) for a in params))


def jax_draws(key, p_layer, corr, image=False):
    """`make_clip`'s (or `make_image_clip`'s) random numbers from its own
    key tree (deflicker_tpu/train/synth.py:226-291, :320-363), through the
    JAX package's own helpers, as the port's `ClipDraws` of one clip."""
    ks = jax.random.split(key, 8)
    if image:
        k_cam, k_start, k_shift, k_warp, k_gain, k_bias, k_field, k_fg = ks
        tex = None
        start = _t(jax.random.uniform(k_start, (2,), minval=-0.5, maxval=0.5))
    else:
        k_tex, k_cam, k_shift, k_warp, k_gain, k_bias, k_field, k_fg = ks
        tex = _tex(jsynth._texture_params(k_tex, 48, 4.0, 96.0))
        start = None
    M, off = jsynth._affine_trajectory(k_cam, T, H, W)
    shift = jax.random.uniform(k_shift, (3,), minval=-0.06, maxval=0.06)
    warp = jsynth._texture_params(k_warp, 8, 24.0, 128.0)
    kf_tex, kf_cam, kf_ell, kf_on, kf_shift, kf_warp = jax.random.split(k_fg, 6)
    fM, foff = jsynth._affine_trajectory(kf_cam, T, H, W, trans_px=2.5)
    ftex = jsynth._texture_params(kf_tex, 48, 4.0, 96.0)
    fshift = jax.random.uniform(kf_shift, (3,), minval=-0.06, maxval=0.06)
    fwarp = jsynth._texture_params(kf_warp, 8, 24.0, 128.0)
    c, rad, ang = jsynth._ellipse_params(kf_ell, H, W)
    fg_on = jax.random.bernoulli(kf_on, p_layer).astype(jnp.float32)
    if corr:
        series = []
        for k in (k_gain, k_bias):
            k_rho, k_e = jax.random.split(k)
            series.append((jax.random.uniform(k_rho, (), maxval=0.9),
                           jax.random.normal(k_e, (T, 3))))
        rho = _t(jnp.stack([series[0][0], series[1][0]]))
        gain, bias = _t(series[0][1]), _t(series[1][1])
    else:
        rho = None
        gain = _t(jax.random.uniform(k_gain, (T, 1, 1, 3), minval=-0.25,
                                     maxval=0.25)[:, 0, 0])
        bias = _t(jax.random.uniform(k_bias, (T, 1, 1, 3), minval=-0.08,
                                     maxval=0.08)[:, 0, 0])
    field = _t(jax.random.uniform(k_field, (T, 3, 4, 1), minval=-0.15,
                                  maxval=0.15)[..., 0])
    return psynth.ClipDraws(
        tex, _t(M), _t(off), start, _t(shift), _tex(warp), _tex(ftex), _t(fM),
        _t(foff), _t(fshift), _tex(fwarp), (_t(c), _t(rad), _t(ang)[0][None]),
        _t(fg_on)[0][None], gain, bias, rho, field)


def _texture():
    return np.random.default_rng(3).uniform(0, 1, TEX_HW + (3,)).astype(
        np.float32)


def _assert_clip_matches(want, got):
    for name in ("clean", "inp", "atlas", "flow_bw"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=CLIP_ATOL, err_msg=name)
    flips = np.mean(got.valid[0].numpy() != np.asarray(want.valid))
    assert flips <= VALID_BAND, flips


CASES = [(0.0, False), (0.0, True), (1.0, False), (1.0, True)]


@pytest.mark.parametrize("p_layer,corr", CASES)
def test_clip_build_matches_jax(p_layer, corr):
    key = jax.random.key(7)
    with _highest():
        want = jsynth.make_clip(key, T, H, W, p_layer=p_layer,
                                corr_flicker=corr)
        draws = jax_draws(key, p_layer, corr)
    _assert_clip_matches(want, psynth.build_clips(draws, H, W))


@pytest.mark.parametrize("p_layer,corr", CASES)
def test_image_clip_build_matches_jax(p_layer, corr):
    key = jax.random.key(9)
    tex = _texture()
    with _highest():
        want = jsynth.make_image_clip(key, jnp.asarray(tex), T, H, W,
                                      p_layer=p_layer, corr_flicker=corr)
        draws = jax_draws(key, p_layer, corr, image=True)
    got = psynth.build_clips(draws, H, W, textures=torch.from_numpy(tex)[None])
    _assert_clip_matches(want, got)


@pytest.mark.parametrize("shape", [(112, 136, 3), (18, 22, 3), (3, 4, 1)])
def test_resize_linear_matches_jax(shape):
    """The image clip's blur (down by 6 with jax's antialiased triangle
    kernel, then back up) and the flicker field's 3x4 -> HxW upsample
    against `jax.image.resize(..., "linear")`, edges included: atol 1e-5 on
    [0, 1] values, the f32 rounding of jax's weighted sums (the port sums in
    f64)."""
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    h, w = shape[:2]
    for oh, ow in ((max(h // 6, 1), max(w // 6, 1)), (6 * h, 6 * w), (H, W)):
        with _highest():
            want = np.asarray(jax.image.resize(jnp.asarray(x), (oh, ow, shape[2]),
                                               "linear"))
        got = psynth.resize_linear(torch.from_numpy(x), oh, ow).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_warp_valid_mask_matches_jax():
    flow = np.random.default_rng(1).normal(0, 6, (3, H, W, 2)).astype(np.float32)
    want = np.asarray(jsynth.warp_valid_mask(jnp.asarray(flow), H, W))
    got = psynth.warp_valid_mask(torch.from_numpy(flow), H, W).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_load_texture_bank_matches_jax(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    for t in range(5):
        cv2.imwrite(str(tmp_path / f"{t:05d}.png"),
                    rng.uniform(0, 255, (40, 50, 3)).astype(np.uint8))
    want = jsynth.load_texture_bank(tmp_path, 64, 72, max_textures=3)
    got = psynth.load_texture_bank(tmp_path, 64, 72, max_textures=3)
    assert got.shape == (3, 64, 72, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert psynth.load_texture_bank(tmp_path / "missing", 64, 64) is None


# ---------------------------------------------------------------------------
# the port's own clips (tests/test_train.py's properties)
# ---------------------------------------------------------------------------

def _warp_residual(clip, t):
    w = flow_warp(clip.clean[t - 1], clip.flow_bw[t])
    m = clip.valid[t]
    return float((torch.abs(w - clip.clean[t]) * m).sum() / (m.sum() * 3 + 1e-8))


@pytest.mark.parametrize("p_layer", [0.0, 1.0])
def test_port_clip_flow_exact_on_valid(p_layer):
    """warp(clean[t-1], flow_bw[t]) == clean[t] on valid pixels, up to the
    bilinear interpolation error of a band-limited texture (< 0.02)."""
    clip = psynth.make_clip(torch.Generator().manual_seed(11), 6, 48, 64,
                            p_layer=p_layer)
    assert clip.clean.shape == (6, 48, 64, 3)
    assert clip.flow_bw.shape == (6, 48, 64, 2)
    assert clip.valid.shape == (6, 48, 64, 1)
    for img in (clip.clean, clip.inp, clip.atlas):
        assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
    assert torch.all(clip.flow_bw[0] == 0) and torch.all(clip.valid[0] == 1)
    for t in range(1, 6):
        assert _warp_residual(clip, t) < 0.02
        inb = psynth.warp_valid_mask(clip.flow_bw[t], 48, 64)
        assert float((clip.valid[t] * (1 - inb)).sum()) == 0.0
    if p_layer:
        cut = sum(float((psynth.warp_valid_mask(clip.flow_bw[t], 48, 64)
                         - clip.valid[t]).clamp(min=0).sum()) for t in range(1, 6))
        assert cut > 0, "a forced foreground layer excluded no pixel"


def test_port_image_clip_flow_exact_on_valid():
    """On a smooth texture (tests/test_train.py's), as for Fourier clips."""
    ys, xs = np.meshgrid(np.linspace(0, 1, 96), np.linspace(0, 1, 96),
                         indexing="ij")
    tex = torch.from_numpy(np.clip(np.stack(
        [0.5 + 0.4 * np.sin(6 * xs + 3 * ys), 0.5 + 0.4 * np.cos(5 * ys),
         xs * ys], axis=-1), 0, 1).astype(np.float32))
    clip = psynth.make_image_clip(torch.Generator().manual_seed(3), tex, 5, 32,
                                  32, p_layer=1.0)
    for t in range(1, 5):
        assert _warp_residual(clip, t) < 0.02


def test_port_clip_flicker_present_atlas_consistent_and_degraded():
    clip = psynth.make_clip(torch.Generator().manual_seed(7), T, H, W)
    clean_std = float(clip.clean.mean((1, 2, 3)).std())
    inp_std = float(clip.inp.mean((1, 2, 3)).std())
    atlas_std = float(clip.atlas.mean((1, 2, 3)).std())
    assert inp_std > 3 * clean_std
    assert atlas_std < 2 * clean_std + 1e-3
    assert float((clip.atlas - clip.clean).abs().mean()) > 0.02


def test_port_clips_vary_by_seed():
    a = psynth.make_clip(torch.Generator().manual_seed(0), 2, 16, 16)
    b = psynth.make_clip(torch.Generator().manual_seed(1), 2, 16, 16)
    c = psynth.make_clip(torch.Generator().manual_seed(0), 2, 16, 16)
    assert float((a.clean - b.clean).abs().mean()) > 0.05
    assert all(torch.equal(x, y) for x, y in zip(a, c))


# ---------------------------------------------------------------------------
# the trainer against the JAX chunks
# ---------------------------------------------------------------------------

CHUNK = dict(height=32, width=32, filter_steps=24, refine_steps=12, batch=2,
             clip_len=3, clip_batch=1, dtype="float32", steps_per_call=2)
LOSS_RTOL = 1e-4
PARAM_REL = 1e-3          # ||p - p_jax|| / ||p_jax||, all params and each kernel
UPDATE_REL = 0.1          # ||dp - dp_jax|| / ||dp_jax|| over all params


def _flat(variables):
    return {k: v.numpy() for k, v in stage2_from_flax(variables).items()}


def _port_clip(c):
    return psynth.Clip(*(torch.from_numpy(np.array(x)) for x in c))


def _jax_chunk_clips(key, bank, cfg, B, Tc, n):
    """The clips a JAX chunk draws: `key, sub = split(key)` a step
    (stage2_trainer.py:149,202), then `_make_clip_batch(sub, ...)`."""
    clips = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        clips.append(_port_clip(jtrain._make_clip_batch(sub, bank, cfg, B, Tc)))
    return clips


@pytest.fixture(scope="module")
def chunks():
    """Two filter steps and two refiner steps of the JAX chunks (compiled
    once for the module) from one init, and the port's steps on the same
    clips."""
    jcfg, pcfg = jtrain.TrainConfig(**CHUNK), ptrain.TrainConfig(**CHUNK)
    bank, jcfg = jtrain._prep_bank(jcfg, None)
    out = {}
    with _highest():
        fvars = j_unet_init(jax.random.key(1), hw=(32, 32))
        lvars = j_tnet_init(jax.random.key(2), hw=(32, 32))
        f0, l0 = _flat(fvars), _flat(lvars)
        unet, tnet = UNet(), TransformNet()
        unet.load_state_dict(stage2_from_flax(fvars))
        tnet.load_state_dict(stage2_from_flax(lvars))

        key = jax.random.key(5)
        clips = _jax_chunk_clips(key, bank, jcfg, jcfg.batch, 1, 2)
        opt = jtrain._make_optimizer(jcfg, jcfg.filter_steps)
        (fvars1, _, _), aux = jtrain._filter_chunk(
            (fvars, opt.init(fvars), key), bank, jcfg, 2)
        popt = ptrain._make_optimizer(unet, pcfg)
        steps = [ptrain._step(popt, pcfg.learning_rate,
                              lambda c=c: ptrain._filter_loss(unet, c, pcfg))
                 for c in clips]
        out["filter"] = (aux, steps, f0, _flat(fvars1), unet)

        key = jax.random.key(6)
        clips = _jax_chunk_clips(key, bank, jcfg, jcfg.clip_batch,
                                 jcfg.clip_len, 2)
        opt = jtrain._make_optimizer(jcfg, jcfg.refine_steps)
        (lvars1, _, _), aux = jtrain._refiner_chunk(
            (lvars, opt.init(lvars), key), fvars1, bank, jcfg, 2)
        popt = ptrain._make_optimizer(tnet, pcfg)
        steps = [ptrain._step(popt, pcfg.learning_rate,
                              lambda c=c: ptrain._refiner_loss(tnet, unet, c,
                                                               pcfg))
                 for c in clips]
        out["refiner"] = (aux, steps, l0, _flat(lvars1), tnet)
    return out


@pytest.mark.parametrize("net", ["filter", "refiner"])
def test_steps_match_jax_chunk(chunks, net):
    """Chunk means within rtol 1e-4; params after within 1e-3 relative (all
    together and each kernel), the update itself within 10 %: Adam's first
    steps are ~lr x sign(g), so an element whose gradient is ~0 (an L1 at
    its kink) may step the other way in either package."""
    aux, steps, p0, want, module = chunks[net]
    for k, v in aux.items():
        got = float(sum(s[k] for s in steps) / len(steps))
        np.testing.assert_allclose(got, float(v), rtol=LOSS_RTOL, err_msg=k)
    got = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    assert set(got) == set(want)
    keys = sorted(want)
    cat = lambda d: np.concatenate([d[k].ravel() for k in keys])  # noqa: E731
    g, w, w0 = cat(got), cat(want), cat(p0)
    assert np.linalg.norm(g - w) / np.linalg.norm(w) < PARAM_REL
    assert np.linalg.norm((g - w0) - (w - w0)) / np.linalg.norm(w - w0) \
        < UPDATE_REL
    for k in keys:
        if k.endswith("weight"):
            rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
            assert rel < PARAM_REL, (k, rel)


@pytest.mark.parametrize("total", [24, 100])
def test_cosine_schedule_matches_optax(total):
    import optax

    cfg = ptrain.TrainConfig(lr_schedule="cosine", learning_rate=3e-4)
    want = optax.warmup_cosine_decay_schedule(
        cfg.learning_rate / 10, cfg.learning_rate,
        max(1, int(0.03 * total)), total, cfg.learning_rate / 20)
    sched = ptrain.lr_schedule(cfg, total)
    for step in range(total + 3):
        np.testing.assert_allclose(sched(step), float(want(step)), rtol=1e-6)
    assert sched(total) == pytest.approx(cfg.learning_rate / 20)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        ptrain.lr_schedule(ptrain.TrainConfig(lr_schedule="nope"), 10)


def test_bf16_filter_step_close_to_f32():
    """One filter step under bf16 autocast against f32 from the same init
    and clips: the losses within 2e-2 relative."""
    cfg = ptrain.TrainConfig(**CHUNK)
    clips = psynth.build_clips(
        psynth.draw_clips(torch.Generator().manual_seed(4), 2, 1, 32, 32),
        32, 32)
    losses = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        unet = ptrain.unet_init(torch.Generator().manual_seed(0))
        opt = ptrain._make_optimizer(unet, c)
        losses[dtype] = float(ptrain._step(
            opt, c.learning_rate,
            lambda: ptrain._filter_loss(unet, clips, c))["total"])
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"], rtol=2e-2)


# ---------------------------------------------------------------------------
# the checkpoint contract and the CLI
# ---------------------------------------------------------------------------

SMALL = ptrain.TrainConfig(height=32, width=32, filter_steps=4, refine_steps=2,
                           batch=2, clip_len=3, clip_batch=1, dtype="float32",
                           steps_per_call=2)


def test_train_stage2_checkpoints_run_the_same_in_jax(tmp_path):
    """`train_stage2` on the CPU writes both `.ckpt` files, scalars.jsonl
    and train_config.json; the JAX package's `load_filter_engine` reads the
    checkpoints, and its `filter_frames` + `refine_sequence` match the
    port's on the same frames at another resolution (64x64, atol 1e-4)."""
    logs = []
    fpath, lpath = ptrain.train_stage2(SMALL, tmp_path,
                                       lambda *a: logs.append(a), device="cpu")
    assert fpath == tmp_path / "neural_filter.ckpt" and fpath.exists()
    assert lpath == tmp_path / "local_refinement_net.ckpt" and lpath.exists()
    rows = [json.loads(x) for x in
            (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert [(r["net"], r["step"]) for r in rows] == \
        [("filter", 2), ("filter", 4), ("refiner", 2)]
    assert set(rows[0]) == {"net", "step", "total", "rec", "grad"}
    assert set(rows[-1]) == {"net", "step", "total", "rec", "temp"}
    assert [(n, s) for n, s, _ in logs] == [(r["net"], r["step"]) for r in rows]
    assert json.loads((tmp_path / "train_config.json").read_text()) == \
        dataclasses.asdict(SMALL)

    rng = np.random.default_rng(0)
    content = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    style = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    jeng_ = jeng.load_filter_engine(fpath, lpath)
    with _highest():
        P = jeng.filter_frames(jeng_.filter_variables, jnp.asarray(content),
                               jnp.asarray(style))
        want = np.asarray(jeng.refine_sequence(jeng_.local_variables, P))
    teng_ = teng.load_filter_engine(fpath, lpath, device="cpu")
    got = teng.refine_sequence(teng_.tnet, teng.filter_frames(
        teng_.unet, torch.from_numpy(content), torch.from_numpy(style)))
    assert got.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_nonfinite_loss_raises(tmp_path):
    """A NaN texture bank drawn on every step: the first chunk's mean is
    not finite, and training stops with the step."""
    bank = np.full((1, 64, 64, 3), np.nan, np.float32)
    cfg = dataclasses.replace(SMALL, texture_mix=1.0)
    with pytest.raises(FloatingPointError, match="non-finite filter loss at step 2"):
        ptrain.train_filter(cfg, 0, texture_bank=bank, device="cpu")


def test_cli_runs_on_cpu_with_a_texture_dir(tmp_path, capsys):
    """`cli.train_stage2.main(..., device="cpu")` with a --texture_dir of
    frames written here: the bank is loaded and used, the JAX CLI's lines
    printed, both checkpoints written."""
    import cv2

    from deflicker_torch.cli import train_stage2

    tex_dir = tmp_path / "textures"
    tex_dir.mkdir()
    rng = np.random.default_rng(0)
    for t in range(2):
        cv2.imwrite(str(tex_dir / f"{t:05d}.png"),
                    rng.uniform(0, 255, (70, 70, 3)).astype(np.uint8))
    out = tmp_path / "out"
    assert train_stage2.main(
        ["--out_dir", str(out), "--filter_steps", "2", "--refine_steps", "2",
         "--size", "32", "--batch", "1", "--clip_len", "2", "--clip_batch",
         "1", "--steps_per_call", "2", "--dtype", "float32",
         "--texture_dir", str(tex_dir), "--texture_mix", "1.0"],
        device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"texture bank: 2 images from {tex_dir}"
    assert lines[1].startswith("[filter] step 2: total=")
    assert lines[1].endswith("it/s)") and " rec=" in lines[1]
    assert lines[2].startswith("[refiner] step 2: total=") and " temp=" in lines[2]
    assert (out / "neural_filter.ckpt").exists()
    assert (out / "local_refinement_net.ckpt").exists()
    assert json.loads((out / "train_config.json").read_text())["texture_mix"] == 1.0


def test_cli_and_trainer_raise_without_cuda(monkeypatch, tmp_path):
    from deflicker_torch.cli import train_stage2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_stage2.main(["--out_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.train_stage2(SMALL, tmp_path)
    assert not (tmp_path / "scalars.jsonl").exists()


def test_shipped_weights_deflicker_a_heldout_clip():
    """The shipped checkpoints on the port's own held-out clip and filter:
    output PSNR above the input's + 3 dB (tests/test_train.py:293-319)."""
    from deflicker_torch.metrics import psnr

    weights = Path(__file__).resolve().parents[1] / "pretrained_weights"
    eng = teng.load_filter_engine(weights / "neural_filter.ckpt",
                                  weights / "local_refinement_net.ckpt",
                                  device="cpu")
    clip = psynth.make_clip(torch.Generator().manual_seed(77_000), 4, 48, 48)
    P = teng.filter_frames(eng.unet, clip.inp, clip.atlas).clamp(0, 1)
    p_in = psnr(clip.inp.numpy(), clip.clean.numpy())
    p_out = psnr(P.numpy(), clip.clean.numpy())
    assert p_out > p_in + 3.0, (p_in, p_out)
