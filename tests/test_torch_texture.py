"""Port vs JAX package: the dual atlas's texture export — the uv area the
video maps into, the discretized atlas, the texture-space render, and the
artifact files — on the same converted params."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflicker_tpu.atlas import engine as jeng
from deflicker_tpu.atlas import texture as jtex
from deflicker_tpu.atlas.data import VideoData as JVideoData
from deflicker_tpu.config import AtlasConfig as JAtlasConfig

from deflicker_torch.atlas import engine as teng
from deflicker_torch.atlas import texture as ttex
from deflicker_torch.atlas.data import VideoData
from deflicker_torch.config import AtlasConfig
from deflicker_torch.utils.convert import atlas_params_from_jax

torch.set_num_threads(2)

T, H, W = 3, 20, 28
NARROW = dict(number_of_channels_atlas=32, number_of_layers_atlas=8,
              number_of_channels_mapping1=32, number_of_layers_mapping1=4,
              number_of_channels_mapping2=32, number_of_layers_mapping2=3,
              number_of_channels_alpha=32, number_of_layers_alpha=4,
              positional_encoding_num_atlas=6)


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(JAtlasConfig(), **NARROW)
    specs_j = jeng.build_specs(cfg_j, dual=True)
    params = jeng.init_models(jax.random.key(2), specs_j)
    host = jax.tree_util.tree_map(np.asarray, params)
    specs_t = teng.build_specs(dataclasses.replace(AtlasConfig(), **NARROW),
                               dual=True)
    rng = np.random.default_rng(0)
    arrays = dict(
        video=rng.uniform(0, 1, (T, H, W, 3)).astype(np.float32),
        dx=np.zeros((T, H, W, 3), np.float32),
        dy=np.zeros((T, H, W, 3), np.float32),
        mask=(rng.uniform(size=(T, H, W)) > 0.4).astype(np.float32),
        flow_fwd=np.zeros((T, H, W, 2), np.float32),
        flow_bwd=np.zeros((T, H, W, 2), np.float32),
        mask_fwd=np.ones((T, H, W), np.float32),
        mask_bwd=np.ones((T, H, W), np.float32))
    d_j = JVideoData(**{k: jnp.asarray(v) for k, v in arrays.items()})
    d_t = VideoData(**arrays)
    return specs_j, specs_t, params, atlas_params_from_jax(host), d_j, d_t


@pytest.mark.parametrize("kind", ["fg", "bg", "fg-chunked", "nothing-passes"])
def test_get_mapping_area_matches_jax(setup, kind):
    """The uv box of the masked, alpha-passing pixels: min/max of the same
    f32 MLP outputs, so equal to 1e-5 absolute; chunking (a chunk that does
    not divide T*H*W) changes nothing; an empty selection gives the whole
    quadrant."""
    specs_j, specs_t, p_j, p_t, d_j, d_t = setup
    L = max(H, W)
    kw = dict(uv_shift=0.5)
    mask_j, mask_t = d_j.mask, d_t.mask
    if kind == "bg":
        kw = dict(uv_shift=-0.5, use_mapping2=True, invert_alpha=True)
        mask_j, mask_t = jnp.ones_like(d_j.mask), np.ones_like(d_t.mask)
    elif kind == "fg-chunked":
        kw["chunk"] = 501
    elif kind == "nothing-passes":
        kw["alpha_thresh"] = 2.0                 # tanh never exceeds 1
    want = jtex.get_mapping_area(p_j, specs_j, mask_j, L, T, **kw)
    got = ttex.get_mapping_area(p_t, specs_t, mask_t, L, T, **kw)
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if kind == "nothing-passes":
        assert got == (1.0, -1.0, 1.0, -1.0, 2.0)
    else:
        maxx, minx, maxy, miny, edge = got
        assert -1.0 <= minx < maxx <= 1.0 and -1.0 <= miny < maxy <= 1.0
        assert edge == pytest.approx(max(maxx - minx, maxy - miny))


def test_get_high_res_texture_matches_jax(setup):
    """The atlas discretized over a box: the same f32 forward on the same
    grid (atol 2e-5); row i is y = ys[i]; the marked copy carries the text
    pattern and equals the JAX package's (cv2 draws on the same uint8
    canvas up to a rounding step of 1/255 where the two textures differ in
    the last f32 bit)."""
    specs_j, specs_t, p_j, p_t, *_ = setup
    box = (0.1, 0.9, 0.2, 0.8)                   # minx, maxx, miny, maxy
    m_j, o_j = jtex.get_high_res_texture(96, *box, p_j["atlas"], specs_j,
                                         add_text_pattern=True)
    m_t, o_t = ttex.get_high_res_texture(96, *box, p_t["atlas"], specs_t,
                                         add_text_pattern=True)
    assert o_t.shape == (96, 96, 3) and o_t.dtype == np.float32
    assert 0.0 <= o_t.min() and o_t.max() <= 1.0
    np.testing.assert_allclose(o_t, o_j, atol=2e-5)
    assert np.abs(m_t - m_j).max() <= 1.0 / 255 + 1e-6
    assert np.abs(m_t - o_t).max() > 0.2         # the pattern is drawn
    plain, same = ttex.get_high_res_texture(96, *box, p_t["atlas"], specs_t)
    np.testing.assert_array_equal(plain, same)
    # texel (i, j) is the atlas at (xs[j], ys[i])
    from deflicker_torch.models.imlp import imlp_apply

    uv = torch.tensor([[np.linspace(0.1, 0.9, 96)[10],
                        np.linspace(0.2, 0.8, 96)[70]]], dtype=torch.float32)
    with torch.no_grad():
        want = 0.5 * (imlp_apply(p_t["atlas"], uv, specs_t.atlas) + 1.0)
    np.testing.assert_allclose(o_t[70, 10], want[0].numpy(), atol=1e-5)


def test_render_from_texture_matches_jax_and_the_atlas(setup):
    """Bilinear sampling of the discretized texture (the port's
    ops/sampling.bilinear_sample) at random uv: equal to the JAX package's
    sample of the same texture (atol 1e-5), and close to the neural atlas
    itself (mean abs < 0.01: the editable-texture property)."""
    specs_j, specs_t, p_j, p_t, *_ = setup
    _, tex = ttex.get_high_res_texture(512, 0.0, 1.0, 0.0, 1.0,
                                       p_t["atlas"], specs_t)
    uv = np.random.default_rng(0).uniform(0.05, 0.95, (500, 2)).astype(np.float32)
    got = ttex.render_from_texture(tex, 0.0, 1.0, 0.0, 1.0, uv, device="cpu")
    want = jtex.render_from_texture(tex, 0.0, 1.0, 0.0, 1.0, uv)
    assert got.shape == (500, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    from deflicker_torch.models.imlp import imlp_apply

    with torch.no_grad():
        direct = 0.5 * (imlp_apply(p_t["atlas"], torch.tensor(uv),
                                   specs_t.atlas) + 1.0)
    assert np.abs(got - direct.numpy()).mean() < 0.01
    # a tensor is sampled where it lies
    grid = ttex.render_from_texture(tex, 0.0, 1.0, 0.0, 1.0,
                                    torch.tensor(uv).reshape(20, 25, 2))
    np.testing.assert_array_equal(grid.reshape(500, 3), got)


def test_export_atlas_artifacts_matches_jax(setup, tmp_path):
    """The artifact set: texture1/2 PNGs (marked and plain) and one alpha
    map per frame; boxes and the texture-render proxy equal the JAX
    package's (1e-5 / 1e-6 absolute); the PNGs are equal up to one 8-bit
    step."""
    from PIL import Image

    specs_j, specs_t, p_j, p_t, d_j, d_t = setup
    out_j = jtex.export_atlas_artifacts(p_j, specs_j, d_j, tmp_path / "jax",
                                        resolution=64)
    out_t = ttex.export_atlas_artifacts(p_t, specs_t, d_t, tmp_path / "torch",
                                        resolution=64)
    assert set(out_t) == set(out_j)
    for k in ("fg_box", "bg_box"):
        np.testing.assert_allclose(out_t[k], out_j[k], atol=1e-5)
    np.testing.assert_allclose(out_t["texture_render_psnr_proxy"],
                               out_j["texture_render_psnr_proxy"], atol=1e-6)
    assert np.isfinite(out_t["texture_render_psnr_proxy"])
    names = ["texture1.png", "texture1_marked.png", "texture2.png",
             "texture2_marked.png"] + [f"alpha/{f:05d}.png" for f in range(T)]
    for n in names:
        a = np.array(Image.open(tmp_path / "torch" / n)).astype(int)
        b = np.array(Image.open(tmp_path / "jax" / n)).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, n
    assert np.array(Image.open(tmp_path / "torch" / "alpha/00000.png")).shape == (H, W, 3)
    with pytest.raises(ValueError, match="dual"):
        ttex.export_atlas_artifacts(p_t, teng.build_specs(AtlasConfig()), d_t,
                                    tmp_path / "single")
