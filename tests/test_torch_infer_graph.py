"""The RAFT solve and the stage-2 refinement step as captured steps
(deflicker_torch/atlas/graphs.py `InferenceGraphs`) on the CPU.
`FakeInferenceGraphs` stands in for `torch.cuda.CUDAGraph`: its capture
runs the step's Python as the card's capture does (the launch counters
count) while the tensors the step reads and writes come out unchanged,
and its replays run the step with the launch counters and the trace's
counters frozen, as a real replay leaves them.  So the warm-up, capture, replay, counter accounting and keys
of `RAFTFlow.compute_batch` and `FilterEngine.refine` / `run` /
`run_multi` run here as on the card; `refine_sequence_multi` is held to
the JAX package's."""

import gc
import inspect
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deflicker_tpu.filter import convert as jconv
from deflicker_tpu.filter import engine as jeng

from deflicker_torch.atlas import graphs as tgraphs
from deflicker_torch.filter import engine as teng
from deflicker_torch.flow import RAFTFlow
from deflicker_torch.models import raft as traft
from deflicker_torch.models.refine import TransformNet, transformnet_init
from deflicker_torch.models.unet import unet_init
from deflicker_torch.ops.cuda import corr_kernel
from deflicker_torch.utils import trace
from deflicker_torch.utils.convert import load_stage2_module

torch.set_num_threads(2)

WEIGHTS = Path(__file__).resolve().parents[1] / "pretrained_weights"
LOCAL = WEIGHTS / "local_refinement_net.ckpt"
ITERS = 3


class FakeGraph:
    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        frozen = [dict(c) for c in tgraphs.COUNTERS]
        counted = trace.counters()
        self.fn()
        for c, saved in zip(tgraphs.COUNTERS, frozen):
            c.update(saved)
        trace._counters.clear()
        trace._counters.update(counted)


class FakeInferenceGraphs(tgraphs.InferenceGraphs):
    """`InferenceGraphs` that captures on the CPU through `FakeGraph`."""

    def __init__(self, device="cpu", what="steps"):
        super().__init__(torch.device(device), what, capture=True)

    def warm_up(self, state, fn):
        fn()

    def _record(self, state, fn):
        # the step's Python runs (its counters count); its tensors keep
        # their values, as a capture launches nothing
        cells = inspect.unwrap(fn).__closure__ or ()
        tensors = [c.cell_contents for c in cells
                   if isinstance(c.cell_contents, torch.Tensor)]
        saved = [t.clone() for t in tensors]
        fn()
        for t, s in zip(tensors, saved):
            t.copy_(s)
        return FakeGraph(fn)

    def replay(self, state, graph, n):
        for _ in range(n):
            graph.replay()


def _raft(capture):
    model = traft.raft_init(torch.Generator().manual_seed(0))
    eng = RAFTFlow(model=model, iters=ITERS, dtype=torch.float32,
                   device="cpu", corr_mode="kernel", capture=False)
    if capture:
        eng.graphs = FakeInferenceGraphs(what="RAFT solves")
    return eng


def _pairs(B, seed, H=64, W=64):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    return a, np.roll(a, 2, axis=2)


@pytest.fixture
def counted_lookups(monkeypatch):
    """The plain twin (the CPU's lookup) counted as the kernel's wrapper
    counts its launches."""
    plain = traft.corr_lookup_plain

    def counted(*args, **kw):
        corr_kernel.launches["lookup"] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(traft, "corr_lookup_plain", counted)
    corr_kernel.reset_launches()
    yield corr_kernel.launches
    corr_kernel.reset_launches()


def test_captured_solve_equals_raft_flow_over_two_batch_shapes():
    """`compute_batch` through the helper at 64x64, batches of 4 and 2
    pairs, each shape solved three times (warm-up, capture, replays):
    every flow equals `raft_flow` on the same padded images bit for bit,
    and each shape is captured once, right after its first solve."""
    eng = _raft(capture=True)
    ref = _raft(capture=False)
    for B, seed in ((4, 0), (2, 1), (4, 2), (2, 3), (4, 4), (2, 5)):
        a, b = _pairs(B, seed)
        got = eng.compute_batch(a, b)
        x1, x2 = (torch.from_numpy(x) for x in (a, b))
        _, want = traft.raft_flow(ref.model, x1, x2, iters=ITERS,
                                  corr_mode="kernel")
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(got, ref.compute_batch(a, b))
    assert eng.graphs.captured == 2
    assert sorted(k[0] for k in eng.graphs.entries) == [2, 4]
    assert all(e.step.graph is not None for e in eng.graphs.entries.values())


def test_captured_solves_count_their_lookups_once_per_replay(counted_lookups):
    """Lookups counted at capture are taken back and each replay adds a
    solve's: after the warm-up solve, the capture and 4 replays the
    counter reads 5 x iterations, as 5 eager solves count."""
    eng = _raft(capture=True)
    a, b = _pairs(2, 0)
    eng.compute_batch(a, b)
    assert counted_lookups["lookup"] == ITERS and eng.graphs.captured == 1
    for _ in range(4):
        eng.compute_batch(a, b)
    assert counted_lookups["lookup"] == 5 * ITERS
    step = next(iter(eng.graphs.entries.values())).step
    assert step.counts == [(corr_kernel.launches, {"lookup": ITERS})]
    corr_kernel.reset_launches()
    ref = _raft(capture=False)
    for _ in range(5):
        ref.compute_batch(a, b)
    assert counted_lookups["lookup"] == 5 * ITERS


def test_solve_key_follows_the_correlation_body(monkeypatch):
    """A body switch between solves selects another graph (the body is
    part of the key), switching back replays the first; the flow is the
    same function under every body."""
    monkeypatch.delenv("DEFLICKER_CORR_SHARED", raising=False)
    monkeypatch.delenv("DEFLICKER_CORR_RESIDENT", raising=False)
    eng = _raft(capture=True)
    a, b = _pairs(2, 0)
    band = eng.compute_batch(a, b)
    monkeypatch.setenv("DEFLICKER_CORR_SHARED", "1")
    shared = eng.compute_batch(a, b)
    assert eng.graphs.captured == 2
    assert [k[-1] for k in eng.graphs.entries] == ["band", "shared"]
    monkeypatch.delenv("DEFLICKER_CORR_SHARED")
    monkeypatch.setenv("DEFLICKER_CORR_RESIDENT", "1")
    eng.compute_batch(a, b)
    monkeypatch.delenv("DEFLICKER_CORR_RESIDENT")
    again = eng.compute_batch(a, b)
    assert eng.graphs.captured == 3
    assert list(eng.graphs.entries)[-1][-1] == "band"
    np.testing.assert_array_equal(band, shared)
    np.testing.assert_array_equal(band, again)


def test_bf16_solve_rounds_frames_without_touching_the_callers():
    """In bf16 the frames are rounded to whole levels before the solve (on
    the device), never in the caller's arrays, which on the CPU the
    upload would otherwise alias: fractional frames and their rounding
    give the same flow, and the caller's arrays keep their fractions."""
    model = traft.raft_init(torch.Generator().manual_seed(0))
    eng = RAFTFlow(model=model, iters=2, device="cpu", corr_mode="kernel")
    a, b = _pairs(1, 0)
    a0, b0 = a.copy(), b.copy()
    got = eng.compute_batch(a, b)
    np.testing.assert_array_equal(a, a0)
    np.testing.assert_array_equal(b, b0)
    assert (a0 % 1 != 0).any()
    np.testing.assert_array_equal(
        got, eng.compute_batch(np.round(a0), np.round(b0)))


def test_inference_graphs_keep_the_most_recent_keys():
    """Past `MAX_KEYS` keys the least recently used entry goes; a key used
    again moves to the back."""
    g = FakeInferenceGraphs()
    made = []
    for k in range(tgraphs.MAX_KEYS):
        g.entry((k,), lambda: made.append(1) or object())
    g.entry((0,), lambda: made.append(1) or object())
    g.entry(("new",), lambda: made.append(1) or object())
    assert len(made) == tgraphs.MAX_KEYS + 1
    assert list(g.entries) == [(k,) for k in range(2, tgraphs.MAX_KEYS)] + [
        (0,), ("new",)]


def _engine(capture, span=4):
    gen = torch.Generator().manual_seed(2)
    eng = teng.FilterEngine(unet_init(gen), transformnet_init(gen),
                            device="cpu", span=span, capture=False)
    if capture:
        eng.graphs = FakeInferenceGraphs(what="refinement steps")
    return eng


@pytest.mark.parametrize("V", [1, 2])
def test_captured_refinement_equals_refine_span_multi(V):
    """`FilterEngine.refine` through the step graph over three spans (4, 4
    and a ragged 2 frames; with V = 2 the second video ends inside the
    second span, so its carry freezes there) equals `refine_span_multi`
    bit for bit: every refined frame and the carry after each span; with
    V = 1 also `refine_span`."""
    eng = _engine(capture=True)
    rng = np.random.default_rng(V)
    frames = torch.from_numpy(rng.uniform(0, 1, (V, 10, 32, 32, 3))
                              .astype(np.float32))
    lengths = [10, 6][:V]
    carry = ref = (frames[:, 0], frames[:, 0])
    ref1 = (frames[0, 0], frames[0, 0])
    for s0, s1 in ((0, 4), (4, 8), (8, 10)):
        body = frames[:, s0:s1]
        nv = [int(np.clip(L - s0, 0, s1 - s0)) for L in lengths]
        carry, got = eng.refine(carry, body, nv)
        ref, want = teng.refine_span_multi(eng.tnet, ref, body, nv)
        assert torch.equal(got, want)
        assert all(torch.equal(x, y) for x, y in zip(carry, ref))
        if V == 1:
            ref1, want1 = teng.refine_span(eng.tnet, ref1, body[0], nv[0])
            assert torch.equal(got[0], want1)
            assert all(torch.equal(x[0], y) for x, y in zip(carry, ref1))
    if V == 2:          # frozen at the second video's last real frame
        assert torch.equal(carry[1][1], frames[1, 5])
    assert eng.graphs.captured == 1


def _write_frames(folder: Path, seed: int, T: int, H=40, W=52):
    import cv2

    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for t in range(T):
        cv2.imwrite(str(folder / f"{t:05d}.png"),
                    rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    return folder


def test_captured_run_and_run_multi_equal_the_eager_engine(tmp_path):
    """`run` over 7 frames (span 3: bodies of 2, 3 and a ragged 1 frame)
    and `run_multi` over videos of 4 and 7 frames through the step graph
    equal the eager engine's bit for bit; one graph each (V = 1, V = 2),
    captured after the first refined frame."""
    c7, s7 = (_write_frames(tmp_path / n, s, 7) for s, n in ((0, "c7"),
                                                            (1, "s7")))
    c4, s4 = (_write_frames(tmp_path / n, s, 4) for s, n in ((2, "c4"),
                                                            (3, "s4")))
    outs = {}
    for capture in (False, True):
        eng = _engine(capture, span=3)
        one = eng.run(c7, s7, tmp_path / f"r{capture}", save_concat=False)
        multi = eng.run_multi([(c4, s4, tmp_path / f"m4{capture}"),
                               (c7, s7, tmp_path / f"m7{capture}")],
                              save_concat=False)
        outs[capture] = (one, multi, eng.graphs.captured)
    (one_e, multi_e, n_e), (one_c, multi_c, n_c) = outs[False], outs[True]
    assert one_c.shape == (7, 64, 64, 3) and n_e == 0 and n_c == 2
    np.testing.assert_array_equal(one_c, one_e)
    for a, b in zip(multi_c, multi_e):
        np.testing.assert_array_equal(a, b)


def test_refine_sequence_multi_matches_jax():
    """Two videos of 4 frames at 32x32 with the shipped weights, f32:
    O_0 = P_0 exactly, the rest within the convs' summation order (atol
    2e-4, as test_torch_batch holds `refine_span_multi`); each video also
    equals `refine_sequence` on it alone within 1e-5."""
    preds = np.random.default_rng(0).uniform(0, 1, (2, 4, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jeng.refine_sequence_multi(
        jconv.load_stage2_checkpoint(LOCAL), jnp.asarray(preds)))
    tnet = load_stage2_module(TransformNet(), LOCAL)
    got = teng.refine_sequence_multi(tnet, torch.from_numpy(preds)).numpy()
    assert got.shape == want.shape == (2, 4, 32, 32, 3)
    np.testing.assert_array_equal(got[:, 0], preds[:, 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    for v in range(2):
        one = teng.refine_sequence(tnet, torch.from_numpy(preds[v])).numpy()
        np.testing.assert_allclose(got[v], one, rtol=0, atol=1e-5)
    single = teng.refine_sequence_multi(tnet, torch.from_numpy(preds[:, :1]))
    np.testing.assert_array_equal(single.numpy(), preds[:, :1])


# -- a warm Deflickerer --------------------------------------------------------

def _deflickerer(tmp, results, ckpt, fake: bool):
    import dataclasses

    from deflicker_torch.api import Deflickerer
    from deflicker_torch.config import AtlasConfig

    from tests.test_torch_serve import TINY

    d = Deflickerer(ckpt_raft=str(ckpt),
                    ckpt_filter=str(WEIGHTS / "neural_filter.ckpt"),
                    ckpt_local=str(LOCAL), root=str(tmp / "data" / "test"),
                    results_root=str(tmp / results), device="cpu")
    d.atlas_cfg = dataclasses.replace(AtlasConfig(), **TINY)
    if fake:
        d.flow_provider.graphs = FakeInferenceGraphs(what="RAFT solves")
        d.filter_engine.graphs = FakeInferenceGraphs(what="refinement steps")
    return d


@pytest.fixture
def raft_clips(tmp_path):
    """Two 64x64 clips of 3 frames and a seeded random RAFT `.pth`."""
    ckpt = tmp_path / "raft-random.pth"
    model = traft.raft_init(torch.Generator().manual_seed(0))
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, ckpt)
    root = tmp_path / "data" / "test"
    vids = []
    for s, n in enumerate(("vid_a", "vid_b")):
        import cv2

        folder = root / n
        folder.mkdir(parents=True)
        base = np.random.default_rng(s).uniform(40, 215, (64, 72, 3))
        for t in range(3):
            cv2.imwrite(str(folder / f"{t:05d}.png"),
                        base[:, 2 * t:2 * t + 64].astype(np.uint8))
        vids.append(folder)
    return tmp_path, ckpt, vids


def test_warm_deflickerer_replays_solves_and_refinement(raft_clips):
    """Two jobs of one shape (RAFT flow from a random `.pth`, stage 2)
    through one `Deflickerer` whose engines capture through the stand-in
    equal each job in a fresh, eager `Deflickerer`: the same metrics and
    final frames.  Job 1 captures one solve and one refinement step; job
    2, of its shape, captures none."""
    import cv2

    from deflicker_torch.io.media import list_frames

    tmp, ckpt, vids = raft_clips
    warm = _deflickerer(tmp, "warm", ckpt, fake=True)
    captured = []
    outs = {}
    for v in vids:
        outs["warm", v.name] = warm.process(frame_folder=str(v), down=2)
        captured.append((warm.flow_provider.graphs.captured,
                         warm.filter_engine.graphs.captured))
        outs["fresh", v.name] = _deflickerer(
            tmp, f"fresh_{v.name}", ckpt, fake=False).process(
                frame_folder=str(v), down=2)
    assert captured == [(1, 1), (1, 1)], captured
    for v in vids:
        a, b = outs["warm", v.name], outs["fresh", v.name]
        for k in ("psnr", "final_psnr", "final_ewarp", "input_ewarp"):
            assert a[k] == b[k], (v.name, k)
        fa = list_frames(tmp / "warm" / v.name / "final" / "output")
        fb = list_frames(tmp / f"fresh_{v.name}" / v.name / "final" / "output")
        assert len(fa) == len(fb) == 3
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(cv2.imread(str(x)), cv2.imread(str(y)))


def test_dropped_deflickerer_frees_its_solve_and_refinement_graphs(raft_clips):
    """The engines' entries (static buffers, captured steps) live while
    the `Deflickerer` does and go with its last reference, with the
    garbage collector off: nothing in them refers back."""
    tmp, ckpt, vids = raft_clips
    d = _deflickerer(tmp, "drop", ckpt, fake=True)
    d.process(frame_folder=str(vids[0]), down=2)
    refs = [weakref.ref(e) for g in (d.flow_provider.graphs,
                                     d.filter_engine.graphs)
            for e in g.entries.values()]
    refs += [weakref.ref(d.flow_provider), weakref.ref(d.filter_engine)]
    gc.disable()
    try:
        held = [r() is not None for r in refs]
        del d
        alive = [r() is not None for r in refs]
    finally:
        gc.enable()
    assert held == [True] * 4
    assert alive == [False] * 4
