"""The frozen work counts agree with hand formulas at the published widths,
and count the algorithm's work whatever implements it."""

import json
from pathlib import Path

import pytest

from benchmark.counts import imlp, peaks, raft

ROOT = Path(__file__).resolve().parents[2]


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_single_step_by_hand():
    atlas = _config("deflicker-single")["atlas"]
    B = 10_000
    m1 = 3 * 256 + 4 * 256 * 256 + 256 * 2          # mapping1: 6 layers, no PE
    at = 40 * 256 + 5 * 256 * 256 + 296 * 256 + 296 * 3   # atlas: PE 10, skips 4, 7
    # forward + weight gradients + input gradients (the skip rows get none;
    # mapping1 needs no input gradient, the atlas does)
    m1_dx = 4 * 256 * 256 + 256 * 2
    at_dx = 40 * 256 + 5 * 256 * 256 + 256 * 256 + 256 * 3
    for it, variants in ((0, 9), (6000, 7)):
        want = (2 * variants * B * (2 * m1 + m1_dx)
                + 2 * 3 * B * (2 * at + at_dx))
        assert imlp.step_work(atlas, False, it)[0] == pytest.approx(want, rel=1e-12)


def test_dual_step_by_hand():
    atlas = _config("deflicker-dual")["atlas"]
    B = 10_000
    single = imlp.step_work(atlas, False, 0)[0]
    m1 = 3 * 256 + 4 * 256 * 256 + 256 * 2
    m1_dx = 4 * 256 * 256 + 256 * 2
    m2 = 3 * 256 + 2 * 256 * 256 + 256 * 2            # 4 layers
    m2_dx = 2 * 256 * 256 + 256 * 2
    al = 30 * 256 + 6 * 256 * 256 + 256               # PE 5 of 3-D, 8 layers
    al_dx = 6 * 256 * 256 + 256
    at = 40 * 256 + 5 * 256 * 256 + 296 * 256 + 296 * 3
    at_dx = 40 * 256 + 5 * 256 * 256 + 256 * 256 + 256 * 3
    want = (2 * 9 * B * (2 * m1 + m1_dx) + 2 * 9 * B * (2 * m2 + m2_dx)
            + 2 * 6 * B * (2 * at + at_dx) + 2 * 5 * B * (2 * al + al_dx))
    assert imlp.step_work(atlas, True, 0)[0] == pytest.approx(want, rel=1e-12)
    assert want > 2 * single


def test_stash_and_remat_count_the_same_work(monkeypatch):
    """The count reads only the configuration: the program's switch between
    the stash and the remat backward changes nothing in it, and the
    recompute a remat backward makes is not counted."""
    atlas = _config("deflicker-dual")["atlas"]
    counts = []
    for stash in ("0", "1"):
        monkeypatch.setenv("DEFLICKER_IMLP_STASH", stash)
        counts.append((imlp.step_work(atlas, True, 0), imlp.step_bound_s(atlas, True, 0)))
    assert counts[0] == counts[1]
    dims = [(3, 256)] + [(256, 256)] * 4 + [(256, 2)]
    flops, _ = imlp.chain_work(dims, (), 1000, False)
    fwd = 2 * 1000 * sum(a * b for a, b in dims)
    recompute = 2 * 1000 * sum(a * b for a, b in dims[:-1])
    assert flops < 3 * fwd and flops + recompute != flops


def test_window_counts_follow_the_phases():
    atlas = _config("deflicker-single")["atlas"]
    spans = [(0, 10001), (0, 100)]
    by_hand = (5101 * imlp.step_work(atlas, False, 0)[0]
               + 5000 * imlp.step_work(atlas, False, 6000)[0])
    assert imlp.steps_flops(atlas, False, spans) == pytest.approx(by_hand)
    assert imlp.steps_flops(atlas, False, spans, 4) == pytest.approx(4 * by_hand)


def test_raft_direction_by_hand():
    H, W, iters = 432, 768, 20
    total = raft.direction_flops(H, W, iters)
    # the stem of one encoder: 3 -> 64, 7x7, stride 2, at 216x384
    stem = 2 * 3 * 49 * 64 * 216 * 384
    gru = 6 * 2 * 384 * 5 * 128 * 54 * 96
    lookups = 4 * 100 * 2 * 256 * 54 * 96
    assert stem in [2 * cin * k[0] * k[1] * cout * ho * wo
                    for _, cin, cout, k, ho, wo, _ in raft.conv_plan(H, W)]
    assert total > 3 * stem + iters * (gru + lookups)
    assert 0.6e12 < total < 0.8e12


def test_lookup_bound_is_the_bytes_at_the_engine_shape():
    import torch

    H8, W8 = 54, 96
    ys, xs = torch.meshgrid(torch.arange(H8, dtype=torch.float32),
                            torch.arange(W8, dtype=torch.float32), indexing="ij")
    coords = torch.stack([xs, ys], -1)[None].expand(8, H8, W8, 2)
    dots = raft.needed_dots(coords, H8, W8)
    assert 0 < dots <= 8 * H8 * W8 * 4 * 100
    bound = raft.lookup_bound_s(8, H8, W8, dots)
    nbytes = (4 * 8 * H8 * W8 * 256 + 2 * 8 * (5184 + 1296 + 312 + 72) * 256
              + 4 * 8 * H8 * W8 * 2 + 4 * 8 * H8 * W8 * 324)
    assert bound == pytest.approx(nbytes / peaks.HBM_BYTES)
