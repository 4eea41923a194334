"""Port vs JAX package: the stage-2 inits (`unet_init`,
`transformnet_init`: flax's lecun-normal kernels and zero biases),
`refine_sequence` with the shipped weights, `coords_grid` and `upflow8`."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflicker_tpu.filter import convert as jconv
from deflicker_tpu.filter import engine as jeng
from deflicker_tpu.models.refine import transformnet_init as j_tnet_init
from deflicker_tpu.models.unet import unet_init as j_unet_init
from deflicker_tpu.ops import convex_upsample as jup
from deflicker_tpu.ops import coords as jcoords

from deflicker_torch.filter import refine_sequence
from deflicker_torch.filter.convert import variables_from_state_dict
from deflicker_torch.models import TransformNet, transformnet_init, unet_init
from deflicker_torch.ops import coords_grid, upflow8
from deflicker_torch.utils.convert import load_stage2_module

torch.set_num_threads(2)

LOCAL = (Path(__file__).resolve().parents[1] / "pretrained_weights"
         / "local_refinement_net.ckpt")

INITS = {"unet": (unet_init, lambda k: j_unet_init(k, hw=(32, 32))),
         "transformnet": (transformnet_init,
                          lambda k: j_tnet_init(k, hw=(32, 32)))}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("name", sorted(INITS))
def test_init_converts_to_the_jax_tree(name):
    """Through `variables_from_state_dict`, the port's init is exactly the
    tree of the JAX init: the same keys at every level, the same shapes."""
    port_init, jax_init = INITS[name]
    ours = dict(_leaves(variables_from_state_dict(
        port_init(torch.Generator().manual_seed(0)).state_dict())))
    theirs = dict(_leaves(jax.tree_util.tree_map(np.asarray,
                                                 jax_init(jax.random.key(0)))))
    assert set(ours) == set(theirs)
    assert {k: v.shape for k, v in ours.items()} == \
        {k: v.shape for k, v in theirs.items()}


@pytest.mark.parametrize("name", sorted(INITS))
def test_init_is_lecun_normal_with_zero_bias(name):
    """Every bias 0; each kernel's std within 10 % of lecun-normal's
    sqrt(1 / fan_in) (the truncated draw is rescaled to that variance),
    nothing beyond 2 sigma of the untruncated normal.  The 10 % holds
    kernels of 1,000 entries or more (a sample std's error there is under
    2.5 %; the UNet's 1x1 output conv has 96); all kernels pooled, in
    units of their own std, within 2 %."""
    port_init, _ = INITS[name]
    net = port_init(torch.Generator().manual_seed(1))
    pooled = []
    for m in net.modules():
        if not isinstance(m, torch.nn.Conv2d):
            continue
        w = m.weight.detach().double()
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        std = (1.0 / fan_in) ** 0.5
        if w.numel() >= 1000:
            assert abs(float(w.std()) / std - 1.0) < 0.10, (m, float(w.std()))
        assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-7
        pooled.append((w / std).flatten())
        if m.bias is not None:
            assert torch.count_nonzero(m.bias) == 0
    assert len(pooled) > 10
    assert abs(float(torch.cat(pooled).std()) - 1.0) < 0.02


@pytest.mark.parametrize("name", sorted(INITS))
def test_init_same_seed_same_weights(name):
    port_init, _ = INITS[name]
    a, b, c = (port_init(torch.Generator().manual_seed(s)).state_dict()
               for s in (3, 3, 4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a if k.endswith("weight"))


def test_refine_sequence_matches_jax():
    """The whole recurrence with the shipped weights, f32, 4 frames of
    48x48: only the convs' summation order differs (atol 1e-4)."""
    preds = np.random.default_rng(0).uniform(0, 1, (4, 48, 48, 3)).astype(
        np.float32)
    want = np.asarray(jeng.refine_sequence(jconv.load_stage2_checkpoint(LOCAL),
                                           jnp.asarray(preds)))
    tnet = load_stage2_module(TransformNet(), LOCAL)
    got = refine_sequence(tnet, torch.from_numpy(preds)).numpy()
    assert got.shape == want.shape == (4, 48, 48, 3)
    np.testing.assert_array_equal(got[0], preds[0])      # O_0 = P_0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_coords_grid_matches_jax():
    got = coords_grid(5, 7)
    assert got.shape == (5, 7, 2) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcoords.coords_grid(5, 7)))
    assert coords_grid(2, 3, dtype=torch.float64).dtype == torch.float64


def test_upflow8_matches_jax():
    """x8 align-corners upsampling, scaled by 8: f32 rounding only (atol
    1e-4 on values up to ~100, a few ulp)."""
    flow = np.random.default_rng(1).normal(0, 3, (2, 5, 6, 2)).astype(
        np.float32)
    want = np.asarray(jup.upflow8(jnp.asarray(flow)))
    got = upflow8(torch.from_numpy(flow)).numpy()
    assert got.shape == want.shape == (2, 40, 48, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
