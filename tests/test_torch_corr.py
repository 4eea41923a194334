"""The port's correlation lookups against the JAX package on the CPU.

Oracles: the JAX materialized lookup (`corr_lookup` over
`build_corr_pyramid`) for f32 storage, and the Pallas kernel itself in
interpret mode over its default bf16 layout for the bf16-stored plain twin
(`corr_lookup_plain`, the function the CUDA kernel is held to on the card).
Inputs come from numpy generators and go to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deflicker_tpu.models import raft as jraft
from deflicker_tpu.ops.pallas.corr_kernel import (corr_lookup_pallas,
                                                  pad_fmap_pyramid)
from deflicker_torch.models import raft as traft
from deflicker_torch.ops.cuda.corr_kernel import (corr_lookup_cuda,
                                                  corr_lookup_plain)

torch.set_num_threads(2)


def _setup(B=2, H=12, W=20, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, W, D)).astype(np.float32),
            rng.normal(size=(B, H, W, D)).astype(np.float32))


def _coords(B, H, W, spread, seed=1):
    """Base grid + uniform flow; a large `spread` pushes windows partly and
    wholly out of the level."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    base = np.stack([xs, ys], axis=-1)[None].repeat(B, axis=0)
    return base + rng.uniform(-spread, spread, (B, H, W, 2)).astype(np.float32)


def _jax_materialized(f1, f2, coords):
    return np.asarray(jraft.corr_lookup(
        jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2)),
        jnp.asarray(coords)))


def _port_lookup(which, f1, f2, coords):
    f1, f2, coords = map(torch.from_numpy, (f1, f2, coords))
    if which == "materialized":
        return traft.corr_lookup(traft.build_corr_pyramid(f1, f2), coords)
    pyr = traft.build_fmap_pyramid(f2)
    if which == "online":
        return traft.corr_lookup_online(f1, pyr, coords, chunk=64)
    return corr_lookup_plain(f1, pyr, coords, chunk=100)


@pytest.mark.parametrize("spread", [3.0, 40.0])
@pytest.mark.parametrize("which", ["materialized", "online", "plain"])
def test_f32_lookups_match_jax_materialized(which, spread):
    """f32 storage on both sides: the difference is the order of f32 sums
    (rtol = atol = 1e-4, the bound of tests/test_pallas_corr.py)."""
    f1, f2 = _setup()
    coords = _coords(*f1.shape[:3], spread)
    ref = _jax_materialized(f1, f2, coords)
    got = _port_lookup(which, f1, f2, coords).numpy()
    assert got.shape == ref.shape == (2, 12, 20, 4 * 81)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("spread", [3.0, 40.0])
def test_bf16_plain_twin_matches_pallas_kernel(spread):
    """The bf16-stored twin against the Pallas kernel in interpret mode over
    its default layout (quad-phase, reduce-first).  Both read the same
    bf16-rounded pyramid (built once, by the JAX package) and multiply it by
    f32 f1 with f32 sums, so rtol = atol = 1e-4 holds as for f32 storage."""
    f1, f2 = _setup(seed=2)
    coords = _coords(*f1.shape[:3], spread, seed=3)
    pyr = jraft.build_fmap_pyramid(jnp.asarray(f2))
    ref = np.asarray(corr_lookup_pallas(
        jnp.asarray(f1), pad_fmap_pyramid(pyr, dtype=jnp.bfloat16),
        jnp.asarray(coords), interpret=True))
    stored = [torch.tensor(np.asarray(lvl.astype(jnp.bfloat16)
                                     .astype(jnp.float32))).to(torch.bfloat16)
              for lvl in pyr]
    got = corr_lookup_plain(torch.from_numpy(f1), stored,
                            torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_ragged_pixel_count_and_empty_level():
    """7x9 pixels, D = 32: the pyramid floor-halves to 3x4, 1x2 and an empty
    0x1 level, which reads zeros (rtol = atol = 1e-4)."""
    f1, f2 = _setup(B=1, H=7, W=9, D=32, seed=4)
    coords = _coords(1, 7, 9, 2.0, seed=5)
    ref = _jax_materialized(f1, f2, coords)
    for which in ("materialized", "online", "plain"):
        got = _port_lookup(which, f1, f2, coords).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
        assert not got[..., 3 * 81:].any()


def test_fmap_pyramid_matches_jax():
    """Floor-halving mean pool, odd sizes included (13x27 -> 6x13 -> 3x6 ->
    1x3); 1e-6: a mean of four f32 values in another order."""
    f2 = np.random.default_rng(6).normal(size=(2, 13, 27, 16)).astype(np.float32)
    ref = jraft.build_fmap_pyramid(jnp.asarray(f2))
    got = traft.build_fmap_pyramid(torch.from_numpy(f2))
    assert [tuple(g.shape) for g in got] == [tuple(r.shape) for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)


def _bilinear_point(f2, x, y):
    """One zero-padded bilinear sample of f2 (H, W, D), in float64."""
    H, W, _ = f2.shape
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    out = np.zeros(f2.shape[-1])
    for yy, wy in ((y0, 1 - (y - y0)), (y0 + 1, y - y0)):
        for xx, wx in ((x0, 1 - (x - x0)), (x0 + 1, x - x0)):
            if 0 <= xx < W and 0 <= yy < H:
                out += wx * wy * f2[yy, xx].astype(np.float64)
    return out


@pytest.mark.parametrize("which", ["materialized", "online", "plain"])
def test_window_channels_put_x_on_the_outer_index(which):
    """Channel i*9 + j samples (x + i - 4, y + j - 4): the reference's quirk.
    Checked on a 12x20 level (not square, random data) against a scalar
    numpy oracle for a few pixels, at level 0; the transposed order is shown
    to miss by far more than the bound (1e-4 of f32 sums)."""
    f1, f2 = _setup(B=1, H=12, W=20, D=64, seed=7)
    coords = _coords(1, 12, 20, 1.5, seed=8)
    got = _port_lookup(which, f1, f2, coords).numpy()[0, :, :, :81]
    for (py, px) in ((3, 5), (6, 14), (10, 2)):
        cx, cy = coords[0, py, px]
        want = np.array([[f1[0, py, px].astype(np.float64)
                          @ _bilinear_point(f2[0], cx + i - 4, cy + j - 4) / 8.0
                          for j in range(9)] for i in range(9)])
        win = got[py, px].reshape(9, 9)
        np.testing.assert_allclose(win, want, rtol=1e-4, atol=1e-4)
        assert np.abs(win.T - want).max() > 0.1


def test_raft_flow_kernel_mode_on_cpu_runs_the_plain_twin():
    """corr_mode="kernel" on CPU tensors goes through the bf16-stored plain
    twin and stays within bf16 storage tolerance of "online" (0.05, the
    bound tests/test_pallas_corr.py gives bf16 storage), at the level of one
    lookup inside raft_flow's setup and of the final flow."""
    f1, f2 = _setup(seed=9)
    coords = _coords(*f1.shape[:3], 5.0, seed=10)
    t1, t2, tc = map(torch.from_numpy, (f1, f2, coords))
    pyr = traft.build_fmap_pyramid(t2)
    online = traft.corr_lookup_online(t1, pyr, tc)
    stored = corr_lookup_plain(t1, [p.to(torch.bfloat16) for p in pyr], tc)
    np.testing.assert_allclose(stored.numpy(), online.numpy(), rtol=0.05, atol=0.05)

    model = traft.raft_init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    im1, im2 = (torch.from_numpy(rng.uniform(0, 255, (1, 64, 96, 3))
                                 .astype(np.float32)) for _ in range(2))
    _, up_o = traft.raft_flow(model, im1, im2, iters=2, corr_mode="online")
    _, up_k = traft.raft_flow(model, im1, im2, iters=2, corr_mode="kernel")
    np.testing.assert_allclose(up_k.numpy(), up_o.numpy(), rtol=0.05, atol=0.05)
    assert not torch.equal(up_k, up_o)         # the bf16 pyramid was really used


def test_corr_mode_selection():
    """`auto` mirrors the JAX package's rule with the CUDA kernel in the
    Pallas kernel's place: always the kernel on a CUDA device; on the CPU
    materialized while B*n_pix^2*4*1.34 <= 2e9 bytes, else online."""
    sel = traft._select_corr_mode
    assert sel("auto", torch.device("cuda"), 1, 100) == "kernel"
    assert sel("auto", torch.device("cpu"), 8, 54 * 96) == "materialized"
    assert sel("auto", torch.device("cpu"), 8, 135 * 240) == "online"
    assert sel("online", torch.device("cuda"), 1, 100) == "online"
    with pytest.raises(ValueError, match="corr_mode"):
        sel("pallas", torch.device("cpu"), 1, 100)


def test_wrappers_reject_what_they_do_not_take():
    f1, f2 = _setup(B=1, H=8, W=8, D=32)
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    coords = torch.from_numpy(_coords(1, 8, 8, 1.0))
    pyr = traft.build_fmap_pyramid(t2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        corr_lookup_cuda(t1, [p.to(torch.bfloat16) for p in pyr], coords)
    with pytest.raises(ValueError, match="floor-halved"):
        corr_lookup_plain(t1, [pyr[0], pyr[2]], coords)
    with pytest.raises(ValueError, match="coords"):
        corr_lookup_plain(t1, pyr, coords[..., :1])
