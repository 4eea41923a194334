"""Port vs JAX package: stage 2 with the SHIPPED weights
(pretrained_weights/*.ckpt), f32, on 64x64 frames."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deflicker_tpu.filter import convert as jconv
from deflicker_tpu.filter import engine as jeng

from deflicker_torch.filter import engine as teng
from deflicker_torch.models.refine import TransformNet
from deflicker_torch.models.unet import UNet
from deflicker_torch.utils.convert import load_stage2_module, stage2_from_flax

torch.set_num_threads(2)

WEIGHTS = Path(__file__).resolve().parents[1] / "pretrained_weights"
FILTER = WEIGHTS / "neural_filter.ckpt"
LOCAL = WEIGHTS / "local_refinement_net.ckpt"


@pytest.fixture(scope="module")
def nets():
    return (load_stage2_module(UNet(), FILTER),
            load_stage2_module(TransformNet(), LOCAL),
            jconv.load_stage2_checkpoint(FILTER),
            jconv.load_stage2_checkpoint(LOCAL))


def _frames(seed, n=2, h=64, w=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)


def test_converter_covers_every_key(nets):
    """Every flax leaf maps to a module key (strict load) and kernels go
    HWIO -> OIHW."""
    unet, tnet, fvars, _ = nets
    sd = stage2_from_flax(fvars)
    assert set(sd) == set(unet.state_dict())
    k = np.asarray(fvars["params"]["encoder1"]["enc1conv1"]["kernel"])
    np.testing.assert_array_equal(sd["encoder1.enc1conv1.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    # dead InstanceNorm keys of a reference checkpoint are skipped
    extra = {"params": {**fvars["params"], "norm_layer": {"bias": np.zeros(3)}}}
    assert set(stage2_from_flax(extra)) == set(sd)


def test_filter_frames_matches_jax(nets):
    """UNet filter at f32: conv summation order only (atol 2e-4 on [0, 1]
    outputs after 23 convolutions)."""
    unet, _, fvars, _ = nets
    content, style = _frames(0), _frames(1)
    want = np.asarray(jeng.filter_frames(fvars, jnp.asarray(content),
                                         jnp.asarray(style), dtype=jnp.float32))
    got = teng.filter_frames(unet, torch.tensor(content), torch.tensor(style),
                             torch.float32).numpy()
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_filter_frames_uint8_input(nets):
    unet, _, fvars, _ = nets
    rng = np.random.default_rng(2)
    c = rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    s = rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    want = np.asarray(jeng.filter_frames(fvars, jnp.asarray(c), jnp.asarray(s)))
    got = teng.filter_frames(unet, torch.tensor(c), torch.tensor(s)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_refine_span_matches_jax(nets):
    """Refinement span with the carry threaded and the n_valid freeze: the
    last span frame is padding, so the carry must be that of frame 2 (f32,
    atol 2e-4 as above)."""
    _, tnet, _, lvars = nets
    preds = _frames(3, n=3)
    p0 = _frames(4, n=1)[0]
    carry_j, out_j = jeng.refine_span(lvars, (jnp.asarray(p0), jnp.asarray(p0)),
                                      jnp.asarray(preds), jnp.int32(2),
                                      dtype=jnp.float32)
    carry_t, out_t = teng.refine_span(tnet, (torch.tensor(p0), torch.tensor(p0)),
                                      torch.tensor(preds), 2, torch.float32)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-4)
    for a, b in zip(carry_t, carry_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)
    np.testing.assert_allclose(carry_t[1].numpy(), preds[1])


def test_bf16_close_to_f32(nets):
    """stage2_dtype="bfloat16": weights and input in bf16, output f32;
    within bf16 resolution of the f32 filter (atol 0.05 on [0, 1])."""
    unet, _, _, _ = nets
    content, style = _frames(5, n=1), _frames(6, n=1)
    f32 = teng.filter_frames(unet, torch.tensor(content), torch.tensor(style))
    u16 = load_stage2_module(UNet(), FILTER).to(torch.bfloat16)
    b16 = teng.filter_frames(u16, torch.tensor(content), torch.tensor(style),
                             torch.bfloat16)
    assert b16.dtype == torch.float32
    assert float((b16 - f32).abs().max()) < 0.05


def test_resolve_ckpt_falls_back_to_shipped(tmp_path):
    got = teng._resolve_ckpt(tmp_path / "neural_filter.pth")
    assert got is not None and got.name == "neural_filter.ckpt"
    assert teng._resolve_ckpt(None) is None
