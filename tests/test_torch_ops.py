"""Port vs JAX package: coordinate, sampling, consistency, padding and resize
ops on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deflicker_tpu.ops import consistency as jcons
from deflicker_tpu.ops import convex_upsample as jup
from deflicker_tpu.ops import coords as jcoords
from deflicker_tpu.ops import pad as jpad
from deflicker_tpu.ops import sampling as jsamp
from deflicker_tpu.metrics import ewarp as jewarp

from deflicker_torch.ops import consistency as tcons
from deflicker_torch.ops import convex_upsample as tup
from deflicker_torch.ops import coords as tcoords
from deflicker_torch.ops import pad as tpad
from deflicker_torch.ops import sampling as tsamp
from deflicker_torch.metrics import ewarp as tewarp

torch.set_num_threads(2)

# f32 elementwise ops in the same order: equal to f32 rounding
TOL = dict(rtol=1e-5, atol=1e-5)


def _img(rng, h=17, w=23, c=3):
    return rng.uniform(0, 1, (h, w, c)).astype(np.float32)


def _flow(rng, h=17, w=23, scale=4.0):
    return rng.uniform(-scale, scale, (h, w, 2)).astype(np.float32)


def test_normalize_xyt(rng):
    j = rng.integers(-5, 200, 100)
    i = rng.integers(-5, 120, 100)
    f = rng.integers(0, 30, 100)
    want = np.asarray(jcoords.normalize_xyt(j, i, f, 192, 30))
    got = tcoords.normalize_xyt(torch.tensor(j), torch.tensor(i),
                                torch.tensor(f), 192, 30).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bilinear_sample_in_and_out_of_bounds(rng):
    img = _img(rng)
    coords = rng.uniform(-3, 26, (40, 5, 2)).astype(np.float32)
    want = np.asarray(jsamp.bilinear_sample(jnp.asarray(img), jnp.asarray(coords)))
    got = tsamp.bilinear_sample(torch.tensor(img), torch.tensor(coords)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_flow_warp(rng):
    img, flow = _img(rng), _flow(rng)
    want = np.asarray(jsamp.flow_warp(jnp.asarray(img), jnp.asarray(flow)))
    got = tsamp.flow_warp(torch.tensor(img), torch.tensor(flow)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_consistency_masks(rng):
    f12 = _flow(rng, scale=1.5)
    f21 = -f12 + rng.normal(0, 0.6, f12.shape).astype(np.float32)
    want = [np.asarray(m) for m in jcons.consistency_masks(jnp.asarray(f12),
                                                           jnp.asarray(f21))]
    got = [m.numpy() for m in tcons.consistency_masks(torch.tensor(f12),
                                                      torch.tensor(f21))]
    for g, w in zip(got, want):
        assert g.dtype == np.bool_ and 0 < w.mean() < 1
        # a float-rounding tie at the threshold may flip a pixel or two
        assert (g != w).mean() < 0.01


def test_resize_flow(rng):
    flow = _flow(rng, 40, 60)
    np.testing.assert_array_equal(tcons.resize_flow(flow, 20, 30),
                                  jcons.resize_flow(flow, 20, 30))


@pytest.mark.parametrize("mode,div", [("other", 32), ("sintel", 8)])
def test_padder(rng, mode, div):
    x = rng.uniform(0, 1, (2, 45, 70, 3)).astype(np.float32)
    jp, tp = jpad.Padder(45, 70, div, mode), tpad.Padder(45, 70, div, mode)
    assert (jp.top, jp.bottom, jp.left, jp.right) == \
        (tp.top, tp.bottom, tp.left, tp.right)
    got = tp.pad(torch.tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp.pad(jnp.asarray(x))))
    np.testing.assert_array_equal(tp.unpad(got).numpy(), x)


def test_resize_bilinear_align_corners(rng):
    x = rng.uniform(0, 1, (2, 7, 9, 4)).astype(np.float32)
    want = np.asarray(jup.resize_bilinear_align_corners(jnp.asarray(x), 14, 18))
    got = tup.resize_bilinear_align_corners(torch.tensor(x), 14, 18).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # agrees with torch's own align-corners upsample
    ref = torch.nn.functional.interpolate(
        torch.tensor(x).permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
        align_corners=True).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_occlusion_and_warp_error(rng):
    f1, f2 = _img(rng), _img(rng)
    fw = _flow(rng, scale=2.0)
    bw = -fw + rng.normal(0, 0.5, fw.shape).astype(np.float32)
    np.testing.assert_array_equal(tewarp.occlusion_mask(fw, bw),
                                  jewarp.occlusion_mask(fw, bw))
    np.testing.assert_allclose(tewarp.warp_error(f1, f2, fw, bw),
                               jewarp.warp_error(f1, f2, fw, bw), rtol=1e-5)
    stack = lambda a: np.stack([a, a[::-1].copy()])
    np.testing.assert_allclose(
        tewarp.warp_error_video(stack(f1), stack(f2), stack(fw), stack(bw),
                                device="cpu"),
        jewarp.warp_error_video(stack(f1), stack(f2), stack(fw), stack(bw)),
        rtol=1e-5)
