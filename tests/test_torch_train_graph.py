"""Stage-2 training as captured steps (deflicker_torch/train/stage2_trainer.py
through `FitGraphs`, deflicker_torch/atlas/graphs.py) on the CPU.

`FakeGraphs` (tests/test_torch_fit_graph.py) stands in for
`torch.cuda.CUDAGraph`: its capture runs the step once in place of the
first replay and its replays run the step with the launch counters frozen.
So the warm-up, the capture a clip kind, the replays in the coin's order,
the LR tensor and the chunk sums run here as on the card: the captured
route against the eager one to the bit, the coin's order, the LR a step,
the short last chunk, no reference cycle, and two chunks of each net
against the JAX package's `_filter_chunk` / `_refiner_chunk` within the
bounds of tests/test_torch_train.py::test_steps_match_jax_chunk.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

import jax

from deflicker_tpu.models.refine import transformnet_init as j_tnet_init
from deflicker_tpu.models.unet import unet_init as j_unet_init
from deflicker_tpu.train import stage2_trainer as jtrain

from deflicker_torch.atlas import graphs as tgraphs
from deflicker_torch.models import TransformNet, UNet
from deflicker_torch.models.unet import unet_init
from deflicker_torch.train import stage2_trainer as ptrain
from deflicker_torch.utils.convert import stage2_from_flax

from tests.test_torch_fit_graph import FakeGraphs
from tests.test_torch_train import (CHUNK, LOSS_RTOL, PARAM_REL, UPDATE_REL,
                                    _flat, _highest, _jax_chunk_clips)

torch.set_num_threads(2)

SMALL = ptrain.TrainConfig(height=32, width=32, batch=2, clip_len=3,
                           clip_batch=2, steps_per_call=3)
STEPS = 8


def _bank():
    return np.random.default_rng(3).uniform(0, 1, (4, 64, 64, 3)).astype(
        np.float32)


def _frozen_unet():
    return unet_init(torch.Generator().manual_seed(7))


def _train(net, cfg, graphs, bank, steps=STEPS, log_callback=None, seed=1):
    """`steps` steps of the filter or the refiner on the CPU through
    `graphs` (None: eager): (net, logs)."""
    if net == "filter":
        return ptrain.train_filter(
            dataclasses.replace(cfg, filter_steps=steps), seed, log_callback,
            bank, "cpu", graphs)
    return ptrain.train_refiner(
        dataclasses.replace(cfg, refine_steps=steps), seed, _frozen_unet(),
        log_callback, bank, "cpu", graphs)


class RecordingGraphs(FakeGraphs):
    """The stand-in graphs, each warm-up, capture and replay recorded with
    the step function it ran."""

    def __init__(self, events):
        super().__init__()
        self.events = events

    def warm_up(self, state, fn):
        self.events.append(("warm", fn))
        super().warm_up(state, fn)

    def _record(self, state, fn):
        self.events.append(("capture", fn))
        return super()._record(state, fn)

    def replay(self, state, graph, n):
        self.events.extend([("replay", graph.fn)] * n)
        super().replay(state, graph, n)


def _coin_kinds(seed, cfg, n, B):
    """The clip kind of each of n steps (True: image clips), from a replica
    of the run's CPU stream (`_ClipSource`'s coin, then an image step's
    bank indices)."""
    _, data_seed = ptrain._seeds(seed, 2)
    _, pick_seed = ptrain._seeds(data_seed, 2)
    pick = torch.Generator().manual_seed(pick_seed)
    kinds = []
    for _ in range(n):
        image = float(torch.rand((), generator=pick)) < cfg.texture_mix
        if image:
            torch.randint(0, len(_bank()), (B,), generator=pick)
        kinds.append(image)
    return kinds


@pytest.mark.parametrize("bank", [False, True], ids=["fourier", "bank"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", ["filter", "refiner"])
def test_captured_steps_equal_eager_steps(net, dtype, bank):
    """STEPS steps through the stand-in graphs (two warm-up steps, then
    one capture, a clip kind) equal STEPS eager steps of the same step
    functions to the bit: params and chunk logs.  With a bank both kinds
    are captured."""
    cfg = dataclasses.replace(SMALL, dtype=dtype)
    b = _bank() if bank else None
    fake = FakeGraphs()
    got, logs = _train(net, cfg, fake, b)
    want, want_logs = _train(net, cfg, None, b)
    assert logs == want_logs
    for (k, p), q in zip(got.state_dict().items(), want.state_dict().values()):
        assert torch.equal(p, q), k
    assert fake.captured == (2 if bank else 1)


def test_the_coin_picks_the_graph_in_its_order():
    """With a bank, each step runs the step function of the kind its coin
    picked, in the coin's order; each kind warms up on its first two
    picks, is captured right before its third and replays after."""
    events = []
    _train("filter", SMALL, RecordingGraphs(events), _bank(), steps=12)
    kinds = _coin_kinds(1, SMALL, 12, SMALL.batch)
    steps = [(what, fn) for what, fn in events if what != "capture"]
    assert len(steps) == 12
    fn_of = {}
    for (what, fn), image in zip(steps, kinds):
        assert fn_of.setdefault(image, fn) is fn
    assert len(fn_of) == 2 and fn_of[True] is not fn_of[False]
    for image, fn in fn_of.items():
        mine = [what for what, f in events if f is fn]
        picks = kinds.count(image)
        assert picks >= 3, (image, kinds)
        assert mine == ["warm", "warm", "capture"] + ["replay"] * (picks - 2)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_the_lr_of_each_step_is_the_schedule(monkeypatch, schedule):
    """The LR Adam reads at each step, through the stand-in graphs, is
    `lr_schedule` at that 0-based step in f32 (cosine: 70 steps, a warmup
    of 2, then the decay)."""
    seen = []
    make = ptrain._make_optimizer

    def recorded(net, cfg):
        opt = make(net, cfg)
        opt.register_step_pre_hook(lambda o, args, kwargs: seen.append(
            o.param_groups[0]["lr"].item()))
        return opt

    monkeypatch.setattr(ptrain, "_make_optimizer", recorded)
    cfg = dataclasses.replace(SMALL, lr_schedule=schedule, batch=1,
                              steps_per_call=10)
    net = torch.nn.Conv2d(6, 3, 1)
    clips = ptrain._ClipSource(cfg, None, 0, torch.device("cpu"), 1, 1)

    def loss(batch):
        x = torch.cat([batch.inp[:, 0], batch.atlas[:, 0]], -1)
        pred = net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        rec = ptrain._l1(pred, batch.clean[:, 0])
        return rec, {"rec": rec}

    fake = FakeGraphs()
    ptrain._train(net, loss, cfg, clips, 70, "filter", None, fake)
    sched = ptrain.lr_schedule(cfg, 70)
    assert seen == [float(np.float32(sched(k))) for k in range(70)]
    assert fake.captured == 1
    if schedule == "cosine":
        assert seen[0] < seen[1] < seen[2] > seen[3] > seen[-1]


def test_a_short_last_chunk_replays_fewer_times():
    """7 steps in chunks of 3: the first chunk warms up twice and captures
    once, the second replays 3 times, the last 1 time and captures
    nothing; the logs come at steps 3, 6, 7."""
    events = []
    _, logs = _train("refiner", SMALL, RecordingGraphs(events), None,
                     steps=7, log_callback=lambda *a: events.append(("log",)))
    chunks, cur = [], []
    for ev in events:
        if ev[0] == "log":
            chunks.append(cur)
            cur = []
        else:
            cur.append(ev[0])
    assert chunks == [["warm", "warm", "capture", "replay"], ["replay"] * 3,
                      ["replay"]]
    assert [r["step"] for r in logs] == [3, 6, 7]


def test_a_training_run_leaves_no_reference_cycle(monkeypatch):
    """A captured training run's state (its graphs' state, the captured
    steps, the clip source with its generator and bank) goes when the run
    returns, with no wait for the garbage collector."""
    seen = []

    def watched(cls):
        class Watch(cls):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                seen.append(weakref.ref(self))
        return Watch

    for name in ("GraphState", "CapturedStep", "_ClipSource"):
        monkeypatch.setattr(ptrain, name, watched(getattr(ptrain, name)))
    gc.disable()
    try:
        net, _ = _train("filter", SMALL, FakeGraphs(), _bank(), steps=6)
        alive = [r() is not None for r in seen]
    finally:
        gc.enable()
    assert len(alive) == 4 and not any(alive)
    assert isinstance(net, UNet)


# ---------------------------------------------------------------------------
# the captured route against the JAX chunks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_chunks():
    """Two chunks of two steps of each JAX chunk function from one init,
    with the clips they drew: {net: (chunk means, clips, init, params
    after)}, init a state dict of numpy arrays; the refiner's frozen UNet
    is the JAX filter after its chunks."""
    jcfg = jtrain.TrainConfig(**CHUNK)
    bank, jcfg = jtrain._prep_bank(jcfg, None)
    out = {}
    with _highest():
        for net, chunk, init, B, T, steps in (
                ("filter", jtrain._filter_chunk,
                 j_unet_init(jax.random.key(1), hw=(32, 32)), jcfg.batch, 1,
                 jcfg.filter_steps),
                ("refiner", jtrain._refiner_chunk,
                 j_tnet_init(jax.random.key(2), hw=(32, 32)),
                 jcfg.clip_batch, jcfg.clip_len, jcfg.refine_steps)):
            key = jax.random.key(5 if net == "filter" else 6)
            clips = _jax_chunk_clips(key, bank, jcfg, B, T, 4)
            frozen = () if net == "filter" else (out["filter"][3],)
            p0 = _flat(init)
            carry = (init, jtrain._make_optimizer(jcfg, steps).init(init), key)
            means = []
            for _ in range(2):
                carry, aux = chunk(carry, *frozen, bank, jcfg, 2)
                means.append({k: float(v) for k, v in aux.items()})
            out[net] = (means, clips, p0, carry[0])
    return out


@pytest.mark.parametrize("net", ["filter", "refiner"])
def test_captured_route_matches_jax_chunks(monkeypatch, jax_chunks, net):
    """Four steps in two chunks of two through the stand-in graphs (the
    second chunk captures and replays) on the JAX chunks' own clips and
    init: each chunk's means within rtol 1e-4, the params after within
    1e-3 relative (all together and each kernel) and the update within
    10 %, test_steps_match_jax_chunk's bounds."""
    means, clips, p0, after = jax_chunks[net]
    queue = list(clips)

    class JaxClips(ptrain._ClipSource):
        def draw(self, image):
            return queue.pop(0)

    cfg = ptrain.TrainConfig(**{**CHUNK, "filter_steps": 4,
                                "refine_steps": 4})
    init = UNet() if net == "filter" else TransformNet()
    init.load_state_dict({k: torch.from_numpy(v) for k, v in p0.items()})
    monkeypatch.setattr(ptrain, "_ClipSource", JaxClips)
    monkeypatch.setattr(ptrain, "unet_init" if net == "filter"
                        else "transformnet_init", lambda gen: init)
    fake = FakeGraphs()
    if net == "filter":
        module, logs = ptrain.train_filter(cfg, 0, device="cpu", graphs=fake)
    else:
        frozen = UNet()
        frozen.load_state_dict(stage2_from_flax(jax_chunks["filter"][3]))
        module, logs = ptrain.train_refiner(cfg, 0, frozen, device="cpu",
                                            graphs=fake)
    assert not queue and fake.captured == 1
    assert [r["step"] for r in logs] == [2, 4]
    for rec, want in zip(logs, means):
        assert set(rec) == {"step", *want}
        for k, v in want.items():
            np.testing.assert_allclose(rec[k], v, rtol=LOSS_RTOL, err_msg=k)
    got = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    want = _flat(after)
    keys = sorted(want)
    assert set(got) == set(want)
    cat = lambda d: np.concatenate([d[k].ravel() for k in keys])  # noqa: E731
    g, w, w0 = cat(got), cat(want), cat(p0)
    assert np.linalg.norm(g - w) / np.linalg.norm(w) < PARAM_REL
    assert np.linalg.norm((g - w0) - (w - w0)) / np.linalg.norm(w - w0) \
        < UPDATE_REL
    for k in keys:
        if k.endswith("weight"):
            rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
            assert rel < PARAM_REL, (k, rel)


def test_the_gate_names_training_like_the_fit(capsys):
    """On the CPU, and with `eager=True`, a training run says on one line
    to stderr that its steps run uncaptured, and why."""
    _train("filter", SMALL, None, None, steps=1)
    _train("refiner", SMALL, tgraphs.FitGraphs(eager=True), None, steps=1)
    err = capsys.readouterr().err.splitlines()
    assert ("[deflicker_torch] filter training steps run uncaptured: the "
            "CPU has no CUDA graphs") in err
    assert ("[deflicker_torch] refiner training steps run uncaptured: the "
            "caller asked for it") in err
