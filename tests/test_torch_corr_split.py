"""The arithmetic of the tensor-core correlation bodies (the shared and
resident bodies of deflicker_torch/csrc/corr_lookup.cu), on the CPU.

The kernel splits f32 f1 into bf16 terms t0 = bf16(f), t1 = bf16(f - t0),
t2 = bf16(f - t0 - t1) and multiplies each by the bf16 pyramid on the tensor
cores: every bf16 x bf16 product is exact in f32, and the sums are f32.
`split_terms` below is that split in PyTorch; the lookup computed from the
terms (the plain twin run on each term, summed) is held against the plain
twin of f1 within the kernel's tolerances (relative Frobenius 1e-4, max abs
1e-3 of max |plain|) and against the JAX package's Pallas kernel in interpret
mode within the bound tests/test_torch_corr_variants.py uses (rtol = atol =
1e-4).  The staging rule's mirror `tile_plan` is checked against a direct
per-tile computation and, at the flow engine's 54 x 96 grid, shown to stage
every tile of every level at +-0.5 and +-3 px.  No card and no nvcc needed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deflicker_tpu.models import raft as jraft
from deflicker_tpu.ops.pallas.corr_kernel import (corr_lookup_pallas,
                                                  pad_fmap_pyramid)
from deflicker_torch.ops.cuda import corr_kernel as C

torch.set_num_threads(2)

SPREADS = (0.5, 3.0, 40.0)
SHAPES = ((2, 54, 96, 256), (2, 13, 27, 64), (1, 7, 9, 32))
LEVELS_54x96 = [(54, 96), (27, 48), (13, 24), (6, 12)]
TERMS = 2                    # csrc/corr_lookup.cu: TERMS


def split_terms(f: torch.Tensor, n: int):
    """f32 `f` as n bf16 terms, each the bf16 rounding of what the terms
    before it leave (the kernel's `write_a`)."""
    terms, rest = [], f.float()
    for _ in range(n):
        t = rest.to(torch.bfloat16)
        terms.append(t)
        rest = rest - t.float()          # exact in f32
    return terms


@pytest.mark.parametrize("n", [2, 3])
def test_split_terms_reconstruct_f1(n):
    """Three terms carry all 24 bits of an f32 (their sum, taken in f64, is
    f exactly); two carry 16, within 2^-17 of |f|."""
    f = torch.from_numpy(np.random.default_rng(0).normal(
        scale=3.0, size=(4096,)).astype(np.float32))
    terms = split_terms(f, n)
    assert all(t.dtype == torch.bfloat16 for t in terms)
    total = sum(t.double() for t in terms)
    err = (total - f.double()).abs()
    if n == 3:
        assert float(err.max()) == 0.0
    else:
        assert bool((err <= 2.0 ** -17 * f.double().abs()).all())
        assert float(err.max()) > 0.0            # two terms do drop bits


def _inputs(B, H, W, D, seed=0):
    """f1, f2 and coords = grid + uniform flow for every spread of SPREADS,
    stacked on the batch axis (B elements a spread)."""
    rng = np.random.default_rng(seed)
    S = len(SPREADS)
    f1 = rng.normal(size=(S * B, H, W, D)).astype(np.float32)
    f2 = rng.normal(size=(S * B, H, W, D)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    spread = np.repeat(np.asarray(SPREADS, np.float32), B)[:, None, None, None]
    coords = np.stack([xs, ys], -1)[None] + spread * rng.uniform(
        -1, 1, (S * B, H, W, 2)).astype(np.float32)
    return f1, f2, coords


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def lookups(request):
    """For one shape: the bf16 pyramid (built by the JAX package), the JAX
    Pallas kernel's lookup in interpret mode, the plain twin of f1, and the
    lookup from f1's TERMS split terms (the kernel's count: two)."""
    B, H, W, D = request.param
    f1, f2, coords = _inputs(B, H, W, D)
    pyr = jraft.build_fmap_pyramid(jnp.asarray(f2))
    ref = np.asarray(corr_lookup_pallas(
        jnp.asarray(f1), pad_fmap_pyramid(pyr, dtype=jnp.bfloat16),
        jnp.asarray(coords), interpret=True))
    stored = [torch.tensor(np.asarray(lvl.astype(jnp.bfloat16)
                                     .astype(jnp.float32))).to(torch.bfloat16)
              for lvl in pyr]
    t1, tc = torch.from_numpy(f1), torch.from_numpy(coords)
    plain = C.corr_lookup_plain(t1, stored, tc)
    split = sum(C.corr_lookup_plain(t.float(), stored, tc)
                for t in split_terms(t1, TERMS))
    return B, ref, plain, split


@pytest.mark.parametrize("k", range(len(SPREADS)), ids=[str(s) for s in SPREADS])
def test_split_lookup_matches_plain_and_pallas(lookups, k):
    B, ref, plain, split = lookups
    sl = slice(k * B, (k + 1) * B)
    got, want = split[sl], plain[sl]
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    rel = float((got - want).norm() / want.norm())
    assert rel < 1e-4
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), ref[sl], rtol=1e-4, atol=1e-4)


def _coords(B, H, W, spread, seed):
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    return torch.from_numpy(np.stack([xs, ys], -1)[None] + rng.uniform(
        -spread, spread, (B, H, W, 2)).astype(np.float32))


@pytest.mark.parametrize("spread", [0.5, 3.0])
def test_every_tile_stages_at_the_engine_shape(spread):
    """8 x 54 x 96, four levels: at +-0.5 and +-3 px every 8 x 8 tile's union
    window fits the envelope at every level, so the shared body runs all of
    them on the tensor cores."""
    plan = C.tile_plan(_coords(8, 54, 96, spread, seed=1), LEVELS_54x96)
    assert plan.shape == (4, 8, 7, 12)
    assert bool(plan.all())


def test_scattered_flow_leaves_the_fine_levels_unstaged():
    """+-40 px: the union windows of levels 0 and 1 outgrow the envelope (the
    band body's route takes them), levels 2 and 3 still stage."""
    plan = C.tile_plan(_coords(8, 54, 96, 40.0, seed=2), LEVELS_54x96)
    share = plan.flatten(1).float().mean(1).tolist()
    assert share[0] == 0.0 and share[1] == 0.0
    assert share[2] == 1.0 and share[3] == 1.0


def test_tile_plan_matches_a_direct_count():
    """The mirror against the rule written out tile by tile: the real
    pixels' window corners (floor of the clamped, scaled coords, minus 4),
    their union widened by 10, at most 4 blocks of 8 a side; ragged edges
    (13 x 27) and an empty last level."""
    B, H, W = 2, 13, 27
    coords = _coords(B, H, W, 9.0, seed=3)
    shapes = [(13, 27), (6, 13), (3, 6), (1, 3), (0, 1)]
    plan = C.tile_plan(coords, shapes)
    for l, (hl, wl) in enumerate(shapes):
        for b in range(B):
            for ty in range(2):
                for tx in range(4):
                    c = coords[b, 8 * ty:8 * ty + 8, 8 * tx:8 * tx + 8].reshape(-1, 2)
                    x = (c[:, 0] / 2.0 ** l).clamp(-6.0, wl + 5.0)
                    y = (c[:, 1] / 2.0 ** l).clamp(-6.0, hl + 5.0)
                    x0, y0 = torch.floor(x).long() - 4, torch.floor(y).long() - 4
                    cols = int(x0.max() - x0.min()) + 10
                    rows = int(y0.max() - y0.min()) + 10
                    want = hl > 0 and wl > 0 and -(-cols // 8) <= 4 and -(-rows // 8) <= 4
                    assert bool(plan[l, b, ty, tx]) == want, (l, b, ty, tx)
    assert not plan[4].any()


def test_resident_levels_count_positions_in_eights():
    """A resident level takes its H_l W_l positions rounded up to 8 (the
    kernel's TMA boxes of 8 rows): 3 x 5 at D = 64 is 16 x 128 bytes."""
    assert C.resident_levels([(3, 5)], 64, 2047) == ()
    assert C.resident_levels([(3, 5)], 64, 2048) == (0,)
    assert C.resident_levels(LEVELS_54x96, 256, 41_728) == (3,)
