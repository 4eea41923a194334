"""The stage-1 fit as captured steps (deflicker_torch/atlas/graphs.py) on
the CPU, where nothing is captured: what the eager path shares with the
card's captured one.  `make_fit_step` and the pretrain step against plain
loops written here, the fit's chunk cadence across the global-rigidity
boundary, one step against the JAX package's, a warm `Deflickerer` against
fresh ones.  `FakeGraphs` stands in for `torch.cuda.CUDAGraph`: its
"capture" records the step and runs it once (standing in for the first
replay, which it then skips), its replays run the step with the launch
counters frozen, as a real replay leaves them; so the capture helper's
warm-up, counter accounting and cache of states run here as on the card."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deflicker_tpu.atlas import data as jdata
from deflicker_tpu.atlas import engine as jeng
from deflicker_tpu.config import AtlasConfig as JAtlasConfig

from deflicker_torch.atlas import data as tdata
from deflicker_torch.atlas import engine as teng
from deflicker_torch.atlas import graphs as tgraphs
from deflicker_torch.atlas import multifit as tmulti
from deflicker_torch.config import AtlasConfig
from deflicker_torch.losses import safe_norm
from deflicker_torch.models.imlp import imlp_apply
from deflicker_torch.ops.coords import normalize_xyt
from deflicker_torch.ops.cuda import imlp_kernel
from deflicker_torch.utils.convert import atlas_params_from_jax

torch.set_num_threads(2)

T, H, W = 4, 24, 32
NARROW = dict(number_of_channels_atlas=32, number_of_layers_atlas=8,
              number_of_channels_mapping1=32, number_of_layers_mapping1=4,
              positional_encoding_num_atlas=6, samples_batch=96)


class FakeGraph:
    """A stand-in for a captured CUDA graph: `fn` recorded at capture."""

    def __init__(self, fn):
        self.fn = fn
        self.first = True

    def replay(self):
        if self.first:          # the capture ran this step already
            self.first = False
            return
        frozen = [dict(c) for c in tgraphs.COUNTERS]
        self.fn()
        for c, saved in zip(tgraphs.COUNTERS, frozen):
            c.update(saved)


class FakeGraphs(tgraphs.FitGraphs):
    """`FitGraphs` that captures on the CPU through `FakeGraph`."""

    def uncaptured(self, device, sharded=False):
        return "the sample-sharded fit" if sharded else None

    def warm_up(self, state, fn):
        fn()

    def _record(self, state, fn):
        fn()
        return FakeGraph(fn)

    def replay(self, state, graph, n):
        for _ in range(n):
            graph.replay()


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """Frames plus a flow cache in the reference's layout."""
    import cv2

    root = tmp_path_factory.mktemp("fit_graph") / "data"
    frames, flows = root / "vid", root / "vid_flow"
    frames.mkdir(parents=True)
    flows.mkdir()
    rng = np.random.default_rng(0)
    base = rng.uniform(30, 220, (H, W + T, 3))
    for t in range(T):
        cv2.imwrite(str(frames / f"{t:05d}.png"),
                    base[:, t:t + W].astype(np.uint8))
    for t in range(T - 1):
        f12 = np.zeros((H, W, 2), np.float32)
        f12[..., 0] = -1.0 + 0.3 * rng.normal(size=(H, W))
        f21 = -f12 + 0.8 * rng.normal(size=(H, W, 2)).astype(np.float32)
        np.save(flows / f"{t:05d}.png_{t + 1:05d}.png.npy", f12)
        np.save(flows / f"{t + 1:05d}.png_{t:05d}.png.npy", f21)
    return frames


@pytest.fixture(scope="module")
def setup(video_dir):
    cfg = dataclasses.replace(AtlasConfig(), **NARROW)
    data = tdata.load_video_data(video_dir, H, W, 200)
    specs = teng.build_specs(cfg)
    params = teng.init_models(specs, torch.Generator().manual_seed(0))
    teng.pretrain_mapping(params["mapping1"], specs.mapping1,
                          torch.Generator().manual_seed(1), T, H, W,
                          cfg.uv_mapping_scale, pretrain_iters=10, batch=256)
    return cfg, data, specs, params


def _copy(params):
    return {k: [{kk: t.detach().clone().requires_grad_() for kk, t in l.items()}
                for l in v] for k, v in params.items()}


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(teng.flat_params(a),
                                                 teng.flat_params(b)))


def _plain_fit_steps(params, loss_fn, packed, gen, n, shape):
    """The fit loop as it ran before steps were captured: draw (j, i, f),
    loss, backward, Adam, the terms summed in a dict."""
    opt = teng.make_optimizer(params, 1e-4)
    sums = None
    for _ in range(n):
        j = torch.randint(0, W, shape, generator=gen)
        i = torch.randint(0, H, shape, generator=gen)
        f = torch.randint(0, T, shape, generator=gen)
        total, aux = loss_fn(params, packed, j, i, f)
        opt.zero_grad(set_to_none=True)
        total.sum().backward()
        opt.step()
        aux = {k: v.detach() for k, v in aux.items()}
        sums = aux if sums is None else {k: sums[k] + aux[k] for k in sums}
    return opt, sums


@pytest.mark.parametrize("include_global", [True, False])
def test_fit_step_equals_the_plain_loop(setup, include_global):
    """`make_fit_step` run 7 times equals the plain loop bit for bit:
    params, Adam moments and step, chunk sums, generator state."""
    cfg, data, specs, params = setup
    packed = data.with_packed().packed
    loss_fn = teng.make_loss_fn(specs, cfg, data, include_global)
    shape = (cfg.samples_batch,)

    ref = _copy(params)
    g_ref = torch.Generator().manual_seed(4)
    opt_ref, sums_ref = _plain_fit_steps(ref, loss_fn, packed, g_ref, 7, shape)

    mine = _copy(params)
    gen = torch.Generator().manual_seed(4)
    opt = teng.make_optimizer(mine, 1e-4)
    step = teng.make_fit_step(loss_fn, mine, opt, packed, gen, shape)
    for _ in range(7):
        step()
    assert _equal_trees(mine, ref)
    assert step.sums["keys"] == sorted(sums_ref)
    for n, k in enumerate(step.sums["keys"]):
        assert torch.equal(step.sums["vals"][n], sums_ref[k]), k
    for p, q in zip(teng.flat_params(mine), teng.flat_params(ref)):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], opt_ref.state[q][key]), key
    assert torch.equal(gen.get_state(), g_ref.get_state())


def _plain_pretrain(params, spec, gen, iters, batch, V=None):
    """The pretrain as it ran before: `for sweep: for f in range(T)`."""
    opt = teng._adam([l[k] for l in params for k in ("w", "b")], 1e-4)
    L = max(H, W)
    for _ in range(iters):
        for f in range(T):
            if V is None:
                i = torch.randint(0, H, (batch,), generator=gen)
                j = torch.randint(0, W, (batch,), generator=gen)
                frame = torch.full((batch,), f)
            else:
                i, j = tmulti.pretrain_samples(gen, V, batch, H, W, "cpu")
                frame = torch.full((V, batch), f)
            xyt = normalize_xyt(j, i, frame, L, T)
            uv = imlp_apply(params, xyt, spec)
            err = safe_norm(xyt[..., :2] * 0.8 - uv)
            loss = torch.mean(err) if V is None else torch.mean(err, -1).sum()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()


@pytest.mark.parametrize("graphs", [None, "fake"])
@pytest.mark.parametrize("V", [None, 2])
def test_pretrain_frame_counter_keeps_the_sweep_order(setup, V, graphs):
    """The pretrain step with its device frame counter, eager or through
    the stand-in graph, equals the `for sweep: for f in range(T)` loop bit
    for bit: params and generator state (so the draws came in order)."""
    cfg, _, specs, _ = setup
    spec = specs.mapping1
    init = (teng.init_models(specs, torch.Generator().manual_seed(2))
            if V is None else tmulti.init_models_multi(
                specs, torch.Generator().manual_seed(2), V))["mapping1"]
    ref = [{k: t.detach().clone().requires_grad_() for k, t in l.items()}
           for l in init]
    g_ref = torch.Generator().manual_seed(6)
    _plain_pretrain(ref, spec, g_ref, 3, 40, V)

    mine = [{k: t.detach().clone().requires_grad_() for k, t in l.items()}
            for l in init]
    gen = torch.Generator().manual_seed(6)
    fake = FakeGraphs() if graphs else None
    kw = dict(pretrain_iters=3, batch=40, graphs=fake)
    if V is None:
        teng.pretrain_mapping(mine, spec, gen, T, H, W, 0.8, **kw)
    else:
        tmulti.pretrain_mapping_multi(mine, spec, gen, T, H, W, 0.8, **kw)
    for a, b in zip(mine, ref):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    assert torch.equal(gen.get_state(), g_ref.get_state())
    if fake is not None:
        assert fake.captured == 1


@pytest.mark.parametrize("graphs", [None, "fake"])
def test_fit_cadence_across_the_global_rigidity_boundary(setup, graphs):
    """The chunk ends, logged iterations and eval points of
    tests/test_torch_atlas.py::test_fit_cadence_logs_and_eval, eager and
    through the stand-in graphs (one capture a loss phase, each after
    WARMUP_STEPS eager steps); both fits equal to the bit."""
    cfg, data, specs, params = setup
    c = dataclasses.replace(cfg, iters_num=12, steps_per_call=5,
                            stop_global_rigidity=6, evaluate_every=10)
    runs = {}
    for name in ("eager", graphs or "eager"):
        p = _copy(params)
        evals = []
        fake = FakeGraphs() if name == "fake" else None
        res = teng.fit_atlas(p, specs, data, c, torch.Generator().manual_seed(0),
                             eval_callback=lambda i, pp, o: evals.append(i),
                             graphs=fake)
        assert [r["iteration"] for r in res.logs] == [4, 6, 10, 11]
        assert "global_rigidity1" in res.logs[1]
        assert "global_rigidity1" not in res.logs[2]
        assert evals == [10] and res.iteration == 12
        assert res.opt_state["step"] == 12
        if fake is not None:
            assert fake.captured == 2
        runs[name] = res
    a, b = runs["eager"], runs[graphs or "eager"]
    assert a.logs == b.logs and _equal_trees(a.params, b.params)


def test_fit_step_matches_one_jax_step(setup, video_dir):
    """One step of `make_fit_step` against one step of the JAX package's
    loss and optax.adam on the samples the step drew (read back from a
    copy of its generator): params within 2e-6, as
    tests/test_torch_atlas.py::test_one_adam_step_matches holds them."""
    cfg, data, specs, params = setup
    c = dataclasses.replace(cfg, fit_precision="highest")
    cj = dataclasses.replace(JAtlasConfig(), **NARROW, fit_precision="highest")
    gen = torch.Generator().manual_seed(9)
    replica = torch.Generator()
    replica.set_state(gen.get_state())
    B = c.samples_batch
    j, i, f = (torch.randint(0, n, (B,), generator=replica)
               for n in (W, H, T))

    p = _copy(params)
    opt = teng.make_optimizer(p, c.learning_rate)
    step = teng.make_fit_step(teng.make_loss_fn(specs, c, data, True), p, opt,
                              data.with_packed().packed, gen, (B,))
    step()

    d_j = jdata.load_video_data(video_dir, H, W, 200).with_packed()
    specs_j = jeng.build_specs(cj, dual=False)
    host = {k: [{kk: t.detach().numpy() for kk, t in l.items()} for l in v]
            for k, v in params.items()}
    pj = jax.tree_util.tree_map(jnp.asarray, host)
    lf = jeng.make_loss_fn(specs_j, cj, d_j, True, False)
    g = jax.grad(lambda q: lf(q, d_j, *(jnp.asarray(x.numpy())
                                        for x in (j, i, f)))[0])(pj)
    adam = optax.adam(cj.learning_rate)
    upd, _ = adam.update(g, adam.init(pj), pj)
    new = optax.apply_updates(pj, upd)
    for net in ("mapping1", "atlas"):
        for lt, lj in zip(p[net], new[net]):
            for key in ("w", "b"):
                np.testing.assert_allclose(lt[key].detach().numpy(),
                                           np.asarray(lj[key]), atol=2e-6)


def test_capture_takes_back_its_launches_and_counts_replays():
    """A step that counts 2 chain launches a call, run 3 + 9 steps through
    `CapturedStep` on the stand-in: 2 warm-up steps, one capture (taken
    back), 10 replays; the counter reads 2 a step, 24, and the step ran 12
    times."""
    calls = []

    def step():
        calls.append(1)
        imlp_kernel.launches["fwd"] += 2

    fake = FakeGraphs()
    st = tgraphs.FitState([{"w": torch.zeros(1), "b": torch.zeros(1)}], None,
                          torch.Generator(), {})
    runner = tgraphs.CapturedStep(step)
    imlp_kernel.reset_launches()
    runner.run(fake, st, 3)
    assert (runner.warm, fake.captured, imlp_kernel.launches["fwd"]) == (2, 1, 6)
    runner.run(fake, st, 9)
    assert imlp_kernel.launches["fwd"] == 24 and len(calls) == 12
    assert runner.counts == [(imlp_kernel.launches, {"fwd": 2})]
    imlp_kernel.reset_launches()
    # uncaptured: every call counts itself
    tgraphs.CapturedStep(step).run(None, st, 4)
    assert imlp_kernel.launches["fwd"] == 8
    imlp_kernel.reset_launches()


def test_kept_states_are_keyed_by_what_a_step_computes(setup):
    """Kept graphs: a second fit of the same shape (another seed, more
    steps) captures nothing and equals a fit through fresh graphs; a
    schedule field leaves the key alone, a step's field (the batch)
    makes a new state; past `MAX_STATES` (one job's: its fit and two
    mappings' pretrains) the least recently used state goes first."""
    cfg, data, specs, params = setup
    c = dataclasses.replace(cfg, iters_num=9, steps_per_call=4,
                            stop_global_rigidity=3, evaluate_every=100)
    kept = FakeGraphs(keep=True)
    teng.fit_atlas(_copy(params), specs, data, c,
                   torch.Generator().manual_seed(0), graphs=kept)
    assert kept.captured == 2 and len(kept.states) == 1
    c2 = dataclasses.replace(c, iters_num=11, seed=5)
    a = teng.fit_atlas(_copy(params), specs, data, c2,
                       torch.Generator().manual_seed(5), graphs=kept)
    b = teng.fit_atlas(_copy(params), specs, data, c2,
                       torch.Generator().manual_seed(5), graphs=FakeGraphs())
    assert kept.captured == 2 and len(kept.states) == 1
    assert a.logs == b.logs and _equal_trees(a.params, b.params)
    assert a.opt_state["step"] == 11
    for x, y in zip(a.opt_state["exp_avg"], b.opt_state["exp_avg"]):
        np.testing.assert_array_equal(x, y)

    assert teng.step_config(c2) == teng.step_config(c)
    c3 = dataclasses.replace(c, samples_batch=64)
    assert teng.step_config(c3) != teng.step_config(c)
    teng.fit_atlas(_copy(params), specs, data, c3,
                   torch.Generator().manual_seed(0), graphs=kept)
    assert len(kept.states) == 2 and kept.captured == 4
    assert tgraphs.MAX_STATES == 3
    for batch in (32, 16):
        teng.pretrain_mapping(_copy(params)["mapping1"], specs.mapping1,
                              torch.Generator().manual_seed(1), T, H, W, 0.8,
                              pretrain_iters=1, batch=batch, graphs=kept)
    # the first fit's state went; the batch-64 fit's and the pretrains' stay
    assert [k[0] for k in kept.states] == ["fit", "pretrain", "pretrain"]
    assert (64,) in next(iter(kept.states))


def test_adam_state_loads_in_place_and_zeroes(setup):
    """`adam_state_from_host` writes a state the optimizer holds in place
    (the addresses a captured step reads) and zeroes it for a fresh fit."""
    cfg, data, specs, params = setup
    p = _copy(params)
    opt = teng.make_optimizer(p, 1e-4)
    step = teng.make_fit_step(teng.make_loss_fn(specs, cfg, data, True), p,
                              opt, data.with_packed().packed,
                              torch.Generator().manual_seed(0), (32,))
    step()
    step()
    host = teng.adam_state_to_host(opt, p)
    assert host["step"] == 2
    ptrs = [opt.state[q]["exp_avg"].data_ptr() for q in teng.flat_params(p)]
    teng.adam_state_from_host(opt, p, None)
    assert teng.adam_state_to_host(opt, p)["step"] == 0
    assert all(not s["exp_avg"].any() for s in opt.state.values())
    teng.adam_state_from_host(opt, p, host)
    back = teng.adam_state_to_host(opt, p)
    assert back["step"] == 2
    for x, y in zip(back["exp_avg_sq"], host["exp_avg_sq"]):
        np.testing.assert_array_equal(x, y)
    assert ptrs == [opt.state[q]["exp_avg"].data_ptr()
                    for q in teng.flat_params(p)]


def test_warm_deflickerer_equals_fresh_ones(tmp_path):
    """Two jobs of one shape through one `Deflickerer` whose fits capture
    through the stand-in graphs equal each job in a fresh `Deflickerer`
    (eager): the same metrics and the same stage-1 frames; the second job
    captures no graph."""
    import cv2

    from deflicker_torch.io.media import list_frames

    from tests.test_torch_serve import TINY, _write_clip, torch_deflickerer

    root = tmp_path / "data" / "test"
    vids = [_write_clip(root / n, s) for s, n in enumerate(("vid_a", "vid_b"))]
    warm = torch_deflickerer(tmp_path, "warm")
    warm.fit_graphs = FakeGraphs(keep=True)
    outs, captured = {}, []
    for v in vids:
        outs["warm", v.name] = warm.process(frame_folder=str(v), down=2)
        captured.append(warm.fit_graphs.captured)
        outs["fresh", v.name] = torch_deflickerer(
            tmp_path, f"fresh_{v.name}").process(frame_folder=str(v), down=2)
    # pretrain 1 + fit 2 (global rigidity on, then off), then none
    assert captured == [3, 3], captured
    assert TINY["stop_global_rigidity"] < TINY["iters_num"]
    for v in vids:
        a, b = outs["warm", v.name], outs["fresh", v.name]
        for k in ("psnr", "final_psnr", "final_ewarp", "iterations"):
            assert a[k] == b[k], (v.name, k)
        fa = list_frames(tmp_path / "warm" / v.name / "stage_1" / "output")
        fb = list_frames(tmp_path / f"fresh_{v.name}" / v.name / "stage_1"
                         / "output")
        assert len(fa) == len(fb) == 3
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(cv2.imread(str(x)), cv2.imread(str(y)))


def test_a_fit_leaves_no_reference_cycle(setup):
    """A one-shot fit's state (its pack among it) goes when the fit
    returns, with no wait for the garbage collector: no reference cycle
    runs through the captured steps."""
    import gc
    import weakref

    cfg, data, specs, params = setup
    c = dataclasses.replace(cfg, iters_num=6, steps_per_call=3,
                            stop_global_rigidity=2, evaluate_every=100)
    packed = data.with_packed().packed.clone()
    seen = []

    class Watch(FakeGraphs):
        def state(self, *args, **kw):
            st = super().state(*args, **kw)
            seen.append(weakref.ref(st))
            return st

    gc.disable()
    try:
        teng.fit_atlas(_copy(params), specs, data._replace(packed=packed), c,
                       torch.Generator().manual_seed(0), graphs=Watch())
        alive = [r() is not None for r in seen]
    finally:
        gc.enable()
    assert alive == [False]


def test_dropped_kept_graphs_leave_no_reference_cycle(setup):
    """A kept `FitGraphs` (a `Deflickerer`'s) holds its states while it
    lives, and its states (their packs, params and graphs among them) go
    with its last reference, with no wait for the garbage collector: no
    state refers back to it."""
    import gc
    import weakref

    cfg, data, specs, params = setup
    c = dataclasses.replace(cfg, iters_num=6, steps_per_call=3,
                            stop_global_rigidity=2, evaluate_every=100)
    packed = data.with_packed().packed.clone()
    seen = []

    class Watch(FakeGraphs):
        def state(self, *args, **kw):
            st = super().state(*args, **kw)
            seen.append(weakref.ref(st))
            return st

    gc.disable()
    try:
        kept = Watch(keep=True)
        p = _copy(params)
        teng.pretrain_mapping(p["mapping1"], specs.mapping1,
                              torch.Generator().manual_seed(1), T, H, W, 0.8,
                              pretrain_iters=1, batch=32, graphs=kept)
        teng.fit_atlas(p, specs, data._replace(packed=packed), c,
                       torch.Generator().manual_seed(0), graphs=kept)
        held = [r() is not None for r in seen]
        captured = kept.captured
        del kept
        alive = [r() is not None for r in seen]
    finally:
        gc.enable()
    assert (held, captured) == ([True, True], 3)
    assert alive == [False, False]
