"""The arithmetic of the band correlation body (`corr_lookup_kernel` and
`window_products` in deflicker_torch/csrc/corr_lookup.cu), on the CPU.

The kernel takes one pixel a warp and each of its windows as 13 mma.sync
m16n8k16 products, two at a time: an M-tile is 8 consecutive window
positions (`corr_kernel.band_pairs` gives which), each as two rows of A, its two
channel halves of the bf16 pyramid; B holds f1's three bf16 terms of half 0
in columns 0-2 and of half 1 in columns 5-7; the channels of a k-step follow
the order pi (`corr_kernel.band_channels`) that the lanes' loads and the
fragment layout give.  Here a numpy emulation takes the same steps: each
lane's loads and registers as the kernel fills them, the PTX fragment
layout that maps registers to matrix elements, the products k-step by
k-step, the join of a position's columns across four lanes and the skip of
pairs of M-tiles wholly outside the level (`corr_kernel.band_live_pairs`).
Its tables and lookup are held against the plain twin within f32 rounding
and against the JAX package's Pallas kernel in interpret mode (rtol = atol
= 1e-4, as tests/test_torch_corr_split.py holds the tensor-core bodies).
No card and no nvcc needed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import corr_counts
from deflicker_tpu.models import raft as jraft
from deflicker_tpu.ops.pallas.corr_kernel import (corr_lookup_pallas,
                                                  pad_fmap_pyramid)
from deflicker_torch.ops.cuda import corr_kernel as C

torch.set_num_threads(2)

SPREADS = (0.5, 3.0, 40.0)
SHAPES = ((2, 54, 96, 256), (2, 13, 27, 64), (1, 7, 9, 32))
R, K1 = 4, 10
PAIRS = 7                              # pairs of M-tiles a window


# ---------------------------------------------------------------------------
# the kernel's lanes and the m16n8k16 fragment layout
# ---------------------------------------------------------------------------

def chan(D, w, h, t):
    """`Band<D>::chan`: the first channel of lane t's load w in half h."""
    return 64 * w + 32 * h + 8 * t if D >= 64 else 16 * h + 4 * t


def loads(D):
    """(loads a row a lane, channels a load): `Band<D>::NW`, `::CPL`."""
    return (D // 64, 8) if D >= 64 else (1, 4)


def a_channels(D):
    """(D/32, 16, 16) int: the channel the kernel puts at A element (row,
    kk) of each k-step.  Lane (g, t) loads q0 (row g) and q1 (row g + 8):
    CPL channels from chan(w, g % 2, t) of the two positions, and passes
    word(q0, 2v), word(q1, 2v), word(q0, 2v + 1), word(q1, 2v + 1) as
    registers 0-3 of k-step 2w + v; word k holds channels 2k, 2k + 1 of the
    load.  The PTX layout of A (.row, bf16): register i, half e of lane
    (g, t) is element (row g + 8 (i % 2), kk 2t + e + 8 (i // 2))."""
    nw, cpl = loads(D)
    out = np.full((D // 32, 16, 16), -1)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for w in range(nw):
            for v in range(cpl // 4):
                for i in range(4):
                    k = 2 * v + i // 2                     # the word of q0 or q1
                    for e in range(2):
                        row, kk = g + 8 * (i % 2), 2 * t + e + 8 * (i // 2)
                        out[2 * w + v, row, kk] = chan(D, w, g % 2, t) + 2 * k + e
    return out


def b_channels(D):
    """(D/32, 16, 8) int: the channel of f1 whose term sits at B element
    (kk, n) of each k-step, -1 where the column is zero.  Lane (g, t) holds
    column g: term g of half 0 (g < 3), term g - 5 of half 1 (g > 4);
    bf[w][k] packs channels chan(w, h, t) + 2k, + 2k + 1, and k-step 2w + v
    takes bf[w][2v], bf[w][2v + 1].  The PTX layout of B (.col, bf16):
    register i, half e of lane (g, t) is element (kk 2t + e + 8i, n g)."""
    nw, cpl = loads(D)
    out = np.full((D // 32, 16, 8), -1)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        if g in (3, 4):
            continue
        for w in range(nw):
            for v in range(cpl // 4):
                for i in range(2):
                    for e in range(2):
                        out[2 * w + v, 2 * t + e + 8 * i, g] = \
                            chan(D, w, int(g >= 5), t) + 2 * (2 * v + i) + e
    return out


TERM = {0: 0, 1: 1, 2: 2, 5: 0, 6: 1, 7: 2}    # B column -> f1 term


def joined_columns():
    """What each lane holds after the kernel's join, as sets of accumulator
    elements (row, column): the PTX layout of the f32 accumulator (register
    i of lane (g, t) is element (g + 8 (i // 2), 2t + i % 2)), each lane
    adding registers 0 and 1 (rows g) and 2 and 3 (rows g + 8), then
    xor-shuffles by 1 and by 6.  Returns [rows g, rows g + 8] per lane."""
    out = []
    for r in range(2):
        mine = [{(lane // 4 + 8 * r, 2 * (lane % 4) + e) for e in range(2)}
                for lane in range(32)]
        half = [mine[x] | mine[x ^ 1] for x in range(32)]
        out.append([half[x] | half[x ^ 6] for x in range(32)])
    return [[out[0][x], out[1][x]] for x in range(32)]


def split_terms(f, n=3):
    terms, rest = [], f.float()
    for _ in range(n):
        t = rest.to(torch.bfloat16)
        terms.append(t.float())
        rest = rest - t.float()
    return terms


def emulated_tables(f1, stored, coords, chunk=512):
    """(P, L, K1, K1) tables [ax, by] of the kernel's window products: per
    pixel and level the 7 x 16 positions of `band_pairs` (zero outside the
    level or in an empty slot, a dead pair all zero), each as its two half
    rows; per k-step A's channels through `a_channels` and B's f1 terms
    through `b_channels`, summed k-step by k-step in f32; then the kernel's
    join, ((c0 + c1) + (c2 + c3)) of the half-0 row plus ((c4 + c5) + (c6 +
    c7)) of the half-1 row, the zero columns 3 and 4 left out."""
    B, H, W, D = f1.shape
    P = B * H * W
    S = D // 32
    ach = torch.from_numpy(a_channels(D))              # (S, 16 rows, 16 kk)
    bch = torch.from_numpy(b_channels(D))              # (S, 16 kk, 8 n)
    perm = [ach[:, h, :] for h in range(2)]            # (S, 16): rows of half h
    terms = torch.stack(split_terms(f1.reshape(P, D)), -1)       # (P, D, 3)
    bmat = [torch.stack([terms[:, bch[..., n], TERM[n]] for n in cols], -1)
            for cols in ((0, 1, 2), (5, 6, 7))]         # (P, S, 16, 3) a half
    live = C.band_live_pairs(coords, [tuple(l.shape[1:3]) for l in stored])
    live = live.permute(1, 2, 3, 0, 4).reshape(P, len(stored), PAIRS)
    slots = C.band_pairs().reshape(-1, 2)               # (112, 2) (ax, by)
    ax, by = slots[:, 0], slots[:, 1]
    real = ax >= 0
    batch = torch.arange(B).repeat_interleave(H * W)
    cxy = coords.reshape(P, 2)
    out = torch.zeros((P, len(stored), K1 * K1))
    for l, lvl in enumerate(stored):
        hl, wl = lvl.shape[1:3]
        if hl * wl == 0:
            continue
        flat = lvl.reshape(B * hl * wl, D)
        x0, y0 = C._corners(cxy, l, hl, wl, R)
        for s0 in range(0, P, chunk):
            sl = slice(s0, min(P, s0 + chunk))
            x, y = x0[sl, None] + ax, y0[sl, None] + by
            inside = real & (x >= 0) & (x < wl) & (y >= 0) & (y < hl)
            rows = inside & live[sl, l].repeat_interleave(16, dim=1)
            idx = (batch[sl, None] * (hl * wl) + y.clamp(0, hl - 1) * wl
                   + x.clamp(0, wl - 1))
            feats = flat[idx]                            # (C, 112, D) bf16
            col = []
            for h in range(2):
                a = torch.where(rows[..., None, None],
                                feats[..., perm[h]].float(), 0.0)   # (C, 112, S, 16)
                prod = torch.einsum("pmsk,pskn->pmsn", a, bmat[h][sl])
                acc = torch.zeros(prod.shape[0], prod.shape[1], 3)
                for s in range(S):
                    acc = acc + prod[:, :, s]
                col.append(acc)
            c0, c1 = col
            tab = ((c0[..., 0] + c0[..., 1]) + c0[..., 2]) \
                + (c1[..., 0] + (c1[..., 1] + c1[..., 2]))
            out[sl, l, (ax * K1 + by)[real]] = tab[:, real]
    return out.reshape(P, len(stored), K1, K1)


def tables_to_lookup(tables, coords, shapes, D):
    """The 81-point combination of every (pixel, level) table, as
    `table_to_out` and the plain twin make it."""
    P, L = tables.shape[:2]
    out = torch.zeros((P, L, 9, 9))
    cxy = coords.reshape(P, 2).float()
    for l, (hl, wl) in enumerate(shapes):
        lx = (cxy[:, 0] / 2.0 ** l).clamp(-(R + 2.0), wl - 1.0 + R + 2.0)
        ly = (cxy[:, 1] / 2.0 ** l).clamp(-(R + 2.0), hl - 1.0 + R + 2.0)
        wx = (lx - torch.floor(lx))[:, None, None]
        wy = (ly - torch.floor(ly))[:, None, None]
        t = tables[:, l]
        out[:, l] = (((t[:, :9, :9] * (1 - wx) + t[:, 1:, :9] * wx) * (1 - wy)
                      + (t[:, :9, 1:] * (1 - wx) + t[:, 1:, 1:] * wx) * wy)
                     / np.sqrt(D))
    return out.reshape(*coords.shape[:3], L * 81)


def plain_tables(f1, stored, coords):
    """(P, L, K1, K1) f32 dots of f1 with the bf16 pyramid at every integer
    window position, zero outside the level (the plain twin's table), and
    the mask of positions inside the level."""
    B, H, W, D = f1.shape
    P = B * H * W
    step = torch.arange(K1)
    batch = torch.arange(B).repeat_interleave(H * W)
    out = torch.zeros((P, len(stored), K1, K1))
    inside = torch.zeros((P, len(stored), K1, K1), dtype=torch.bool)
    for l, lvl in enumerate(stored):
        hl, wl = lvl.shape[1:3]
        if hl * wl == 0:
            continue
        x0, y0 = C._corners(coords.reshape(P, 2), l, hl, wl, R)
        ix, iy = x0[:, None, None] + step[:, None], y0[:, None, None] + step[None, :]
        valid = (ix >= 0) & (ix < wl) & (iy >= 0) & (iy < hl)
        idx = batch[:, None, None] * hl * wl + iy.clamp(0, hl - 1) * wl + ix.clamp(0, wl - 1)
        feats = lvl.reshape(-1, D)[idx.reshape(-1)].float().reshape(P, K1 * K1, D)
        dots = torch.einsum("pkd,pd->pk", feats, f1.reshape(P, D)).reshape(P, K1, K1)
        out[:, l] = torch.where(valid, dots, 0.0)
        inside[:, l] = valid
    return out, inside


# ---------------------------------------------------------------------------
# the channel order and the fragments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", C.KERNEL_DIMS)
def test_channel_order_is_a_bijection(D):
    perm = C.band_channels(D)
    assert perm.shape == (D,)
    assert sorted(perm.tolist()) == list(range(D))


@pytest.mark.parametrize("D", C.KERNEL_DIMS)
def test_fragments_follow_the_channel_order(D):
    """Every A element of a k-step is filled, the rows of a half hold the
    same channel at a given kk (so each row's product is part of a dot),
    and that channel is pi's; B's columns 0-2 hold the half-0 terms and
    5-7 the half-1 terms at the same channels, columns 3-4 stay zero; after
    the join, lane 8p holds columns 0-3 of position p's half-0 row and 4-7
    of its half-1 row, for rows g and g + 8, and nothing else."""
    a, b = a_channels(D), b_channels(D)
    perm = C.band_channels(D).reshape(D // 32, 2, 16).numpy()
    assert (a >= 0).all()
    for row in range(16):
        assert (a[:, row, :] == perm[:, row % 2, :]).all()
    for n in (0, 1, 2, 5, 6, 7):
        assert (b[..., n] == perm[:, int(n >= 5), :]).all()
    assert (b[..., 3:5] == -1).all()
    joined = joined_columns()
    for p in range(4):
        for r in range(2):
            even, odd = 2 * p + 8 * r, 2 * p + 1 + 8 * r
            assert joined[8 * p][r] == ({(even, n) for n in range(4)}
                                        | {(odd, n) for n in range(4, 8)})


# ---------------------------------------------------------------------------
# the lookup from the emulated products
# ---------------------------------------------------------------------------

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
def band(request):
    """For one shape: the bf16 pyramid (built by the JAX package), the JAX
    Pallas kernel's lookup in interpret mode, the plain twin, and the
    emulated kernel's tables and lookup."""
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
    tables = emulated_tables(t1, stored, tc)
    shapes = [tuple(lvl.shape[1:3]) for lvl in stored]
    return dict(B=B, D=D, f1=t1, coords=tc, stored=stored, ref=ref,
                plain=C.corr_lookup_plain(t1, stored, tc), tables=tables,
                plain_tables=plain_tables(t1, stored, tc),
                lookup=tables_to_lookup(tables, tc, shapes, D))


@pytest.mark.parametrize("k", range(len(SPREADS)), ids=[str(s) for s in SPREADS])
def test_emulated_tables_match_the_plain_dots(band, k):
    """The products of three exact bf16 terms equal f1 . f2 up to the order
    of f32 sums: every table entry within 2^-20 of sum |f1| x max |f2| of
    the plain twin's dot (sixteen f32 roundings of the largest sum the dot
    could reach), and exactly zero outside the level."""
    P = band["tables"].shape[0] // len(SPREADS)
    sl = slice(k * P, (k + 1) * P)
    got = band["tables"][sl]
    want, inside = (x[sl] for x in band["plain_tables"])
    f1 = band["f1"].reshape(len(SPREADS) * P, -1)[sl]
    scale = f1.abs().sum(-1)[:, None, None, None] * float(
        max(lvl.float().abs().max() for lvl in band["stored"] if lvl.numel()))
    assert bool(((got - want).abs() <= 2.0 ** -20 * scale).all())
    assert not bool(got[~inside].any())
    assert bool(inside.any()) and bool(got[inside].any())


@pytest.mark.parametrize("k", range(len(SPREADS)), ids=[str(s) for s in SPREADS])
def test_emulated_lookup_matches_plain_and_pallas(band, k):
    """The lookup from the emulated tables: within f32 rounding of the plain
    twin (relative Frobenius 1e-6, far inside the card's 1e-4) and within
    rtol = atol = 1e-4 of the JAX Pallas kernel in interpret mode."""
    B = band["B"]
    sl = slice(k * B, (k + 1) * B)
    got, want = band["lookup"][sl], band["plain"][sl]
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).norm() / want.norm()) < 1e-6
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), band["ref"][sl], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the M-tile skip
# ---------------------------------------------------------------------------

def _coords(B, H, W, spread, seed):
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    return torch.from_numpy(np.stack([xs, ys], -1)[None] + rng.uniform(
        -spread, spread, (B, H, W, 2)).astype(np.float32))


def test_pairs_cover_the_window_once():
    """`band_pairs` places every one of the 100 window positions in exactly
    one slot, in the kernel's order (slot j of pair i is m = 16 i + j =
    by 10 + ax); the 12 slots past m = 99 are empty."""
    slots = C.band_pairs().reshape(-1, 2)
    real = slots[slots[:, 0] >= 0]
    assert real.shape[0] == K1 * K1
    assert len({(int(a), int(b)) for a, b in real}) == K1 * K1
    assert int((slots[:, 0] < 0).sum()) == 12
    assert (real[:, 1] * K1 + real[:, 0]).tolist() == list(range(K1 * K1))


@pytest.mark.parametrize("spread", SPREADS)
@pytest.mark.parametrize("shape", [(8, 54, 96, 256), (2, 13, 27, 64), (1, 7, 9, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_skipped_pairs_drop_no_position_inside_the_level(shape, spread):
    """Counting the in-level positions of the live pairs of M-tiles gives the
    direct count of needed dots (chip_smoke's `corr_counts`): a skipped pair
    holds none.  At the engine's shape and +-40 px the skip takes out pairs."""
    B, H, W, D = shape
    coords = _coords(B, H, W, spread, seed=4)
    shapes = [(H, W)]
    for _ in range(3):
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    stored = [torch.zeros((B, h, w, D), dtype=torch.bfloat16) for h, w in shapes]
    live = C.band_live_pairs(coords, shapes)
    assert live.shape == (4, B, H, W, PAIRS)
    slots = C.band_pairs()
    ax, by = slots[..., 0], slots[..., 1]
    covered = 0
    for l, (hl, wl) in enumerate(shapes):
        x0, y0 = C._corners(coords, l, hl, wl, R)
        x, y = x0[..., None, None] + ax, y0[..., None, None] + by
        inside = (ax >= 0) & (x >= 0) & (x < wl) & (y >= 0) & (y < hl)
        covered += int((inside & live[l][..., None]).sum())
    _, _, dots = corr_counts(torch.zeros((B, H, W, D)), stored, coords)
    assert covered == dots
    if shape[0] == 8 and spread == 40.0:
        assert float(live.float().mean()) < 0.7        # the work follows the dots
