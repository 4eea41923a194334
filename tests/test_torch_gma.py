"""GMA in the port (deflicker_torch/models/gma.py) on the CPU: its flow
against the plain reference `benchmark/reference/gma.py` in f32 and in
bf16, the attention kernels' plain twin against a direct softmax, GMA's
published state dict loaded strictly and told from RAFT's by its keys,
the entry points solving GMA from a checkpoint, its captured solve through
the stand-in graphs, and RAFT's solve unchanged bit for bit.

Weights are seeded random (`gma_init`) with gamma nonzero: at GMA's initial
gamma = 0 the attention would drop out of every comparison.  Frames are
128 x 192 (16 x 24 positions): the reference samples its correlation
levels with `grid_sample` normalised by (size - 1), as the published
CorrBlock does, so a level one position wide (64 x 96 frames' level 3)
divides by zero there."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import gma as reference
from deflicker_torch.flow import RAFTFlow
from deflicker_torch.flow.convert import load_raft_checkpoint
from deflicker_torch.models import raft as traft
from deflicker_torch.models.gma import GMA, gma_init
from deflicker_torch.ops.convex_upsample import convex_upsample_flow
from deflicker_torch.ops.coords import coords_grid
from deflicker_torch.ops.cuda import attention_kernel as A
from deflicker_torch.ops.cuda.corr_kernel import corr_lookup_plain

from tests.test_torch_infer_graph import FakeInferenceGraphs

torch.set_num_threads(2)

ITERS = 3
GAMMA = 0.9


@pytest.fixture(scope="module")
def model():
    return gma_init(torch.Generator().manual_seed(0), gamma=GAMMA)


def _images(seed, B=2, H=128, W=192):
    gen = torch.Generator().manual_seed(seed)
    a = torch.rand((B, H, W, 3), generator=gen) * 255
    return a, torch.roll(a, shifts=(3, -2), dims=(1, 2))


@pytest.mark.parametrize("dtype,mode", [(torch.float32, "materialized"),
                                        (torch.bfloat16, "kernel")])
def test_gma_flow_follows_the_reference(model, dtype, mode):
    """f32 with the materialized correlation and the f32 attention: the
    same function, sums in another order (1e-3 of the flow's scale, as
    RAFT's reference test).  bf16 with the kernels' twin (bf16 convs, bf16
    q, k, P and v): each conv rounds its input to 8 bits, so three
    iterations move the flow by a few hundredths of a pixel; the bound, a
    mean endpoint distance of 1 % of the flow's largest component, is ten
    times the reading and a twentieth of what dropping the aggregation
    moves it."""
    a, b = _images(1)
    m = gma_init(torch.Generator().manual_seed(0), gamma=GAMMA).to(dtype)
    got = traft.raft_flow(m, a, b, iters=ITERS, dtype=dtype, corr_mode=mode)[1]
    want = reference.flow(reference.Model(model.state_dict()), a, b, iters=ITERS)
    scale = float(want.abs().max())
    assert scale > 1.0
    epe = float((got - want).norm(dim=-1).mean())
    if dtype == torch.float32:
        assert float((got - want).abs().max()) < 1e-3 * scale
    else:
        assert epe < 0.01 * scale
    # the aggregation matters: without it the flow moves far more
    sd = dict(model.state_dict())
    sd["update_block.aggregator.gamma"] = torch.zeros(1)
    dropped = reference.flow(reference.Model(sd), a, b, iters=ITERS)
    assert float((dropped - want).norm(dim=-1).mean()) > 20 * max(epe, 1e-3)


@pytest.mark.parametrize("stored", [torch.bfloat16, torch.float32])
def test_the_twin_is_a_softmax_attention(stored):
    """`build_plain` + `aggregate_plain` against softmax(q k^T / sqrt(128))
    @ v, scaled and added, in f64: with P stored in f32, f32 rounding;
    stored in bf16 (the kernels' layout, padded to 64 keys, the padding
    zero), each weight within a bf16 rounding step, so the sum within 2^-8
    of the sum of |P v|."""
    B, N = 2, 150
    gen = torch.Generator().manual_seed(3)
    qk = torch.randn((B, N, 2 * A.DIM), generator=gen) * 1.5
    v = torch.randn((B, N, A.DIM), generator=gen)
    mf = torch.randn((B, N, A.DIM), generator=gen)
    gamma = torch.tensor([GAMMA])
    probs, stats = A.attention_buffers(B, N, stored, "cpu")
    A.build_plain(qk, probs, stats)
    out = A.aggregate_plain(probs, v, mf, gamma)
    q, k = qk[..., :A.DIM].double(), qk[..., A.DIM:].double()
    attn = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(A.DIM), dim=-1)
    want = mf.double() + GAMMA * (attn @ v.double())
    assert float(attn.amax()) > 10.0 / N              # not a uniform attention
    if stored == torch.float32:
        assert probs.shape == (B, N, N)
        torch.testing.assert_close(out.double(), want, rtol=1e-5, atol=1e-5)
    else:
        assert probs.shape == (B, N, A.padded_keys(N)) and (probs[..., N:] == 0).all()
        assert float((probs[..., :N].double() - attn).abs().max()) <= 2 ** -8 * float(attn.max())
        room = 2 ** -8 * GAMMA * (attn @ v.double().abs())
        assert bool(((out.double() - want).abs() <= room + 1e-5).all())
    torch.testing.assert_close(stats[..., 1].double(), 1.0 / torch.exp2(
        q @ k.transpose(1, 2) * A.SCALE - stats[..., :1].double()).sum(-1),
        rtol=1e-5, atol=0)


def _published_state(arch: str) -> dict:
    """A state dict under the published key names and shapes, as a
    DataParallel checkpoint saves it (`module.` prefix): GMA's from the
    reference's list, RAFT's from `raft_init`."""
    if arch == "raft":
        sd = traft.raft_init(torch.Generator().manual_seed(5)).state_dict()
    else:
        gen = torch.Generator().manual_seed(5)
        sd = {}
        for name, shape, kind in reference.parameter_shapes():
            if kind == "pos_index":
                sd[name] = reference.position_index()
            elif kind == "bn_count":
                sd[name] = torch.zeros((), dtype=torch.long)
            else:
                sd[name] = torch.randn(shape, generator=gen) * 0.05
        # a residual block's norm3 is also its downsample.1: one module
        for name in sd:
            if ".downsample.1." in name:
                sd[name] = sd[name.replace(".downsample.1.", ".norm3.")]
    return {f"module.{k}": v for k, v in sd.items()}


@pytest.mark.parametrize("arch", ["gma", "raft"])
def test_a_checkpoint_loads_strictly_as_the_model_its_keys_name(arch, tmp_path):
    """`load_raft_checkpoint` and `RAFTFlow(checkpoint=...)` pick GMA by
    `att.to_qk.weight` and RAFT by RAFT's keys, every key landing; GMA's
    published dict carries the unread position tables, which load too."""
    path = tmp_path / f"{arch}.pth"
    sd = _published_state(arch)
    torch.save(sd, path)
    model = load_raft_checkpoint(path)
    assert isinstance(model, GMA) is (arch == "gma")
    assert set(model.state_dict()) == {k.removeprefix("module.") for k in sd}
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd["module." + k], rtol=0, atol=0)
    eng = RAFTFlow(checkpoint=path, iters=1, device="cpu")
    assert eng.model.NAME == arch.upper()
    assert "att.pos_emb.rel_height.weight" in model.state_dict() or arch == "raft"


def test_a_gma_dict_missing_a_key_does_not_load(tmp_path):
    sd = _published_state("gma")
    del sd["module.update_block.aggregator.gamma"]
    torch.save(sd, tmp_path / "gma.pth")
    with pytest.raises(RuntimeError, match="gamma"):
        load_raft_checkpoint(tmp_path / "gma.pth")


def test_the_entry_points_solve_gma_from_its_checkpoint(tmp_path, model):
    """`cli.preprocess_flow --model <GMA .pth>` writes GMA's flow cache (the
    same flows as a `RAFTFlow` over the loaded model), and
    `cli.pipeline.make_flow_provider` returns a GMA engine for a GMA
    checkpoint at `ckpt_raft`: no flag names the model."""
    import cv2

    from deflicker_torch.cli import preprocess_flow
    from deflicker_torch.cli.pipeline import make_flow_provider
    from deflicker_torch.config import PipelineConfig

    frames = tmp_path / "vid"
    frames.mkdir()
    base = np.random.default_rng(0).uniform(0, 255, (32, 40, 3)).astype(np.uint8)
    for t in range(3):
        cv2.imwrite(str(frames / f"{t:05d}.png"), np.roll(base, t, axis=1))
    ckpt = tmp_path / "gma-things.pth"
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, ckpt)
    assert preprocess_flow.main(["--vid_name", "vid", "--root", str(tmp_path),
                                 "--model", str(ckpt), "--iters", "1"], device="cpu") == 0
    flows = sorted((tmp_path / "vid_flow").glob("*.npy"))
    assert len(flows) == 4
    eng = RAFTFlow(checkpoint=ckpt, iters=1, device="cpu")
    assert isinstance(eng.model, GMA)
    im = [cv2.cvtColor(cv2.imread(str(frames / f"{t:05d}.png")), cv2.COLOR_BGR2RGB)
          .astype(np.float32) for t in range(3)]
    # the CLI's one batch: both pairs forward, then backward
    flows = eng.compute_batch(np.stack([im[0], im[1], im[1], im[2]]),
                              np.stack([im[1], im[2], im[0], im[1]]))
    for name, want in (("00000.png_00001.png", flows[0]), ("00002.png_00001.png", flows[3])):
        np.testing.assert_array_equal(np.load(tmp_path / "vid_flow" / f"{name}.npy"), want)
    provider = make_flow_provider(PipelineConfig(ckpt_raft=str(ckpt)), "cpu")
    assert isinstance(provider, RAFTFlow) and isinstance(provider.model, GMA)


def test_captured_gma_solve_equals_raft_flow(model):
    """`compute_batch` with a GMA through the stand-in graphs at two batch
    shapes, each solved three times (warm-up, capture, replay): every flow
    equals `raft_flow` on the same images bit for bit, the key names the
    model, and each solve builds the attention once and aggregates through
    it every iteration (the twin's calls, counted)."""
    eng = RAFTFlow(model=model, iters=ITERS, dtype=torch.float32, device="cpu",
                   corr_mode="kernel", capture=False)
    eng.graphs = FakeInferenceGraphs(what="GMA solves")
    calls = {"build": 0, "aggregate": 0}
    build, aggregate = A.build_plain, A.aggregate_plain

    def counted(kind, fn):
        def call(*args, **kw):
            calls[kind] += 1
            return fn(*args, **kw)
        return call

    rng = np.random.default_rng(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(A, "build_plain", counted("build", build))
        mp.setattr(A, "aggregate_plain", counted("aggregate", aggregate))
        for B in (2, 1, 2, 1, 2, 1):
            a = rng.uniform(0, 255, (B, 64, 64, 3)).astype(np.float32)
            b = np.roll(a, 2, axis=2)
            got = eng.compute_batch(a, b)
            want = traft.raft_flow(eng.model, torch.from_numpy(a), torch.from_numpy(b),
                                   iters=ITERS, corr_mode="kernel")[1]
            np.testing.assert_array_equal(got, want.numpy())
    # per solve, the engine's and the comparison's: 6 warm-ups or replays,
    # 2 captures that run the Python, 6 eager comparisons
    assert calls == {"build": 14, "aggregate": 14 * ITERS}
    assert eng.graphs.captured == 2
    assert sorted((k[0], k[3]) for k in eng.graphs.entries) == [(1, "GMA"), (2, "GMA")]


def _parent_raft_flow(model, image1, image2, iters, dtype, corr_mode):
    """`raft_flow` as it read before GMA came in: the update block called
    directly inside the loop."""
    im1 = (2.0 * (image1.float() / 255.0) - 1.0).to(dtype)
    im2 = (2.0 * (image2.float() / 255.0) - 1.0).to(dtype)
    B = im1.shape[0]
    fmaps = model.fnet(torch.cat([im1, im2], dim=0)).float()
    fmap1, fmap2 = fmaps[:B].contiguous(), fmaps[B:].contiguous()
    _, H8, W8, _ = fmap1.shape
    if corr_mode == "materialized":
        pyramid = traft.build_corr_pyramid(fmap1, fmap2)
        lookup = lambda coords: traft.corr_lookup(pyramid, coords)
    else:
        stored = [lvl.to(torch.bfloat16).contiguous()
                  for lvl in traft.build_fmap_pyramid(fmap2)]
        lookup = lambda coords: corr_lookup_plain(fmap1, stored, coords)
    cnet = model.cnet(im1)
    net = torch.tanh(cnet[..., :traft.HIDDEN_DIM])
    inp = torch.relu(cnet[..., traft.HIDDEN_DIM:])
    coords0 = coords_grid(H8, W8, device=fmap1.device)[None].expand(B, H8, W8, 2)
    coords1 = coords0.clone()
    for _ in range(iters):
        corr = lookup(coords1)
        flow = coords1 - coords0
        net, delta = model.update_block(net, inp, corr.to(dtype), flow.to(dtype))
        coords1 = coords1 + delta.float()
    flow_low = coords1 - coords0
    up_mask = model.update_block.mask_head(net)
    return flow_low, convex_upsample_flow(flow_low, up_mask.float(), factor=8)


@pytest.mark.parametrize("dtype,mode", [(torch.float32, "materialized"),
                                        (torch.bfloat16, "kernel")])
def test_raft_solve_is_unchanged(dtype, mode):
    """RAFT's flows are the parent's formula's bit for bit: the solve now
    asks the model for its update step, which for RAFT is the update
    block itself, and makes no attention."""
    m = traft.raft_init(torch.Generator().manual_seed(0)).to(dtype)
    a, b = _images(2, B=2, H=64, W=64)
    with torch.no_grad():
        want = _parent_raft_flow(m, a, b, ITERS, dtype, mode)
    got = traft.raft_flow(m, a, b, iters=ITERS, dtype=dtype, corr_mode=mode)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert m.update_step(None) is m.update_block
