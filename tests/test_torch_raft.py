"""The port's RAFT against the JAX package on the CPU, from the same weights
and the same inputs.

Weights are the JAX package's `raft_init` draw with every norm parameter and
bias perturbed from a numpy seed (a fresh init leaves scale 1, bias 0,
mean 0, var 1, which would hide a swapped key), carried into the port by
`raft_state_from_flax`.  Images come from numpy generators."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflicker_tpu.flow import convert as jconvert
from deflicker_tpu.flow import engine as jengine
from deflicker_tpu.models import raft as jraft
from deflicker_tpu.ops.convex_upsample import \
    convex_upsample_flow as j_convex_upsample
from deflicker_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from deflicker_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from deflicker_torch.flow import convert as tconvert
from deflicker_torch.flow import engine as tengine
from deflicker_torch.models import raft as traft
from deflicker_torch.ops.convex_upsample import convex_upsample_flow
from deflicker_torch.utils.convert import (raft_state_from_flax,
                                           raft_variables_from_state_dict)

torch.set_num_threads(2)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_same_tree(a, b):
    a, b = _leaves(a), _leaves(b)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def variables():
    rng = np.random.default_rng(0)
    v = jax.tree_util.tree_map(np.asarray, jraft.raft_init(
        jax.random.key(0), image_hw=(32, 32)))

    def perturb(path, x):
        k = jax.tree_util.keystr(path)
        if "'bn'" in k:
            if "'var'" in k or "'scale'" in k:
                return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            return rng.normal(0, 0.3, x.shape).astype(np.float32)
        if "'bias'" in k:
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(perturb, v)


@pytest.fixture(scope="module")
def model(variables):
    m = traft.RAFT()
    m.load_state_dict(raft_state_from_flax(variables), strict=True)
    return m


def test_state_dict_is_strict_both_ways(variables, model):
    """Every flax leaf lands under a reference key and nothing else does:
    strict load, and both ways back — the JAX package's converter and the
    port's own — return the same tree bit for bit, so both packages read one
    `.pth` alike."""
    sd = raft_state_from_flax(variables)
    assert set(sd) == set(model.state_dict())
    assert "cnet.layer2.0.downsample.1.running_var" in sd       # norm3's twin
    assert "fnet.layer2.0.downsample.0.weight" in sd
    assert "update_block.mask.2.bias" in sd
    assert not any(k.startswith("fnet.") and "norm" in k for k in sd)
    _assert_same_tree(jconvert.convert_raft_state_dict(model.state_dict()),
                      variables)
    _assert_same_tree(raft_variables_from_state_dict(model.state_dict()),
                      variables)
    with pytest.raises(KeyError, match="unexpected"):
        raft_state_from_flax({**variables, "opt_state": {}})
    bad = copy.deepcopy(variables)
    bad["params"]["fnet"]["conv1"]["scale"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unexpected leaf"):
        raft_state_from_flax(bad)


def _japply(variables, method, *args):
    return np.asarray(jraft.RAFTModules(dtype=jnp.float32).apply(
        variables, *map(jnp.asarray, args), method=method))


def _close(got, ref, rel):
    """atol = rel x the output's scale (max |ref|), no rtol."""
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("which", ["fnet", "cnet"])
def test_encoder_matches_jax(variables, model, which):
    """f32, perturbed norms, a size whose strided convs see odd extents
    (40x56 -> 20x28 -> 10x14 -> 5x7); 1e-4 of the output scale."""
    x = np.random.default_rng(1).uniform(-1, 1, (2, 40, 56, 3)).astype(np.float32)
    ref = _japply(variables, lambda m, a: getattr(m, which)(a), x)
    with torch.no_grad():
        got = getattr(model, which)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 5, 7, 256)
    _close(got, ref, 1e-4)


def test_update_block_step_and_mask_head_match_jax(variables, model):
    """One GRU step (motion encoder, separable GRU with its (0,2)/(2,0)
    paddings, flow head) and the mask head; 1e-4 of each output's scale."""
    rng = np.random.default_rng(2)
    net = np.tanh(rng.normal(size=(2, 6, 9, 128))).astype(np.float32)
    inp = np.abs(rng.normal(size=(2, 6, 9, 128))).astype(np.float32)
    corr = rng.normal(size=(2, 6, 9, 324)).astype(np.float32)
    flow = rng.normal(size=(2, 6, 9, 2)).astype(np.float32)
    net_j, delta_j = jraft.RAFTModules(dtype=jnp.float32).apply(
        variables, *map(jnp.asarray, (net, inp, corr, flow)),
        method=lambda m, *a: m.update_block(*a))
    mask_j = _japply(variables, lambda m, a: m.update_block.mask_head(a), net)
    with torch.no_grad():
        net_t, delta_t = model.update_block(*map(torch.from_numpy,
                                                 (net, inp, corr, flow)))
        mask_t = model.update_block.mask_head(torch.from_numpy(net))
    assert delta_t.shape == (2, 6, 9, 2) and mask_t.shape == (2, 6, 9, 576)
    _close(net_t.numpy(), np.asarray(net_j), 1e-4)
    _close(delta_t.numpy(), np.asarray(delta_j), 1e-4)
    _close(mask_t.numpy(), mask_j, 1e-4)


def test_convex_upsample_matches_jax():
    rng = np.random.default_rng(3)
    flow = rng.normal(size=(2, 5, 7, 2)).astype(np.float32)
    mask = rng.normal(size=(2, 5, 7, 576)).astype(np.float32)
    ref = np.asarray(j_convex_upsample(jnp.asarray(flow), jnp.asarray(mask)))
    got = convex_upsample_flow(torch.from_numpy(flow), torch.from_numpy(mask))
    assert got.shape == (2, 40, 56, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, shape).astype(np.float32),
            rng.uniform(0, 255, shape).astype(np.float32))


@pytest.mark.parametrize("mode", ["materialized", "online"])
def test_raft_flow_matches_jax(variables, model, mode):
    """(1, 128, 160, 3), 3 iterations, f32, the same corr mode on both
    sides; rtol 1e-3, atol 2e-3 — the bounds tests/test_raft.py holds the JAX
    package to against the reference."""
    im1, im2 = _images(4, (1, 128, 160, 3))
    low_j, up_j = jraft.raft_flow(variables, jnp.asarray(im1), jnp.asarray(im2),
                                  iters=3, dtype=jnp.float32, corr_mode=mode)
    low_t, up_t = traft.raft_flow(model, torch.from_numpy(im1),
                                  torch.from_numpy(im2), iters=3,
                                  dtype=torch.float32, corr_mode=mode)
    assert low_t.shape == (1, 16, 20, 2) and up_t.shape == (1, 128, 160, 2)
    assert np.abs(np.asarray(up_j)).max() > 1.0          # not a trivial flow
    np.testing.assert_allclose(low_t.numpy(), np.asarray(low_j),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up_j),
                               rtol=1e-3, atol=2e-3)


def test_raft_flow_checks_its_arguments(model):
    im = torch.zeros((1, 64, 64, 3))
    with pytest.raises(ValueError, match="model.to"):
        traft.raft_flow(model, im, im, iters=1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="divisible by 8"):
        traft.raft_flow(model, im[:, :60], im[:, :60], iters=1)
    with pytest.raises(RuntimeError, match="inference only"):
        model.train()


def test_raft_engine_f32_matches_jax(variables, model):
    """RAFTFlow.compute_batch on 2 pairs at 67x90 (padded to 72x96 inside,
    'sintel' style, and cropped back), f32, 3 iterations: rtol 1e-3, atol
    2e-3 as above."""
    im1, im2 = _images(5, (2, 67, 90, 3))
    ref = jengine.RAFTFlow(variables=variables, iters=3,
                           dtype=jnp.float32).compute_batch(im1, im2)
    eng = tengine.RAFTFlow(model=model, iters=3, dtype=torch.float32,
                           device="cpu")
    got = eng.compute_batch(im1, im2)
    assert got.shape == ref.shape == (2, 67, 90, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-3)
    f12, f21 = eng.compute_pair(im1[0], im2[0])
    both = eng.compute_batch(np.stack([im1[0], im2[0]]),
                             np.stack([im2[0], im1[0]]))
    np.testing.assert_array_equal(f12, both[0])
    np.testing.assert_array_equal(f21, both[1])
    assert model.fnet.conv1.weight.dtype == torch.float32   # caller's model kept


def test_raft_engine_bf16_tracks_jax(variables, model):
    """The default bf16 engine (uint8-rounded input, bf16 convs and GRU, f32
    correlation and flow): the two frameworks round at different places, so
    the bound is loose — mean |difference| under 2 % of the mean |flow|, and
    the worst pixel under 5 % of the largest flow (measured: 0.5 % and
    0.8 %)."""
    im1, im2 = _images(6, (2, 67, 90, 3))
    ref = jengine.RAFTFlow(variables=variables, iters=3).compute_batch(im1, im2)
    got = tengine.RAFTFlow(model=model, iters=3, device="cpu"
                           ).compute_batch(im1, im2)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    diff = np.abs(got - ref)
    assert diff.mean() < 0.02 * np.abs(ref).mean(), (diff.mean(), np.abs(ref).mean())
    assert diff.max() < 0.05 * np.abs(ref).max(), (diff.max(), np.abs(ref).max())


def test_cpu_engine_stages_nothing(model):
    """On the CPU `compute_batch` keeps its pageable route: no pinned
    staging is made, `flow.staging_made` stays at 0, and the flows equal
    `raft_flow` on `torch.from_numpy` of the caller's arrays bit for bit."""
    from deflicker_torch.utils import trace

    im1, im2 = _images(7, (2, 64, 72, 3))
    eng = tengine.RAFTFlow(model=model, iters=2, dtype=torch.float32,
                           device="cpu")
    got = eng.compute_batch(im1, im2)
    assert eng._staging is None
    assert trace.counters().get("flow.staging_made", 0) == 0
    _, want = traft.raft_flow(eng.model, torch.from_numpy(im1),
                              torch.from_numpy(im2), iters=2)
    np.testing.assert_array_equal(got, want.numpy())


def test_checkpoints_load_through_both_packages(variables, model, tmp_path):
    """A `.pth` written by torch.save (reference keys, `module.` prefix,
    bare or under `state_dict`) and the pickled-variables file load through
    both packages' `load_raft_checkpoint` to the same weights; the port's
    `convert_weights --kind raft` writes the file the JAX package reads."""
    from deflicker_torch.cli import convert_weights

    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    torch.save(sd, tmp_path / "raft.pth")
    torch.save({"state_dict": sd}, tmp_path / "wrapped.pt")
    j_save_checkpoint(tmp_path / "raft.ckpt", variables)
    assert convert_weights.main(["--kind", "raft", "--src",
                                 str(tmp_path / "raft.pth"), "--dst",
                                 str(tmp_path / "cli.ckpt")], device="cpu") == 0

    for name in ("raft.pth", "wrapped.pt", "raft.ckpt", "cli.ckpt"):
        _assert_same_tree(jconvert.load_raft_checkpoint(tmp_path / name), variables)
        loaded = tconvert.load_raft_checkpoint(tmp_path / name)
        assert not loaded.training
        for k, v in model.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), (name, k)
    _assert_same_tree(j_load_checkpoint(tmp_path / "cli.ckpt"), variables)

    missing = dict(sd)
    del missing["module.update_block.mask.2.bias"]
    torch.save(missing, tmp_path / "short.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        tconvert.load_raft_checkpoint(tmp_path / "short.pth")
    # --kind filter|local now read a stage-2 `.pth` (test_torch_stage2_pth.py);
    # the strict load refuses a RAFT file given as one
    for kind in ("filter", "local"):
        with pytest.raises(RuntimeError, match="Missing key"):
            convert_weights.main(["--kind", kind, "--src",
                                  str(tmp_path / "raft.pth"), "--dst",
                                  str(tmp_path / f"{kind}.ckpt")], device="cpu")


@pytest.fixture
def five_frames(tmp_path):
    import cv2

    frames = tmp_path / "vid"
    frames.mkdir()
    base = np.random.default_rng(0).uniform(0, 255, (32, 40, 3)).astype(np.uint8)
    for t in range(5):
        cv2.imwrite(str(frames / f"{t:05d}.png"), np.roll(base, t, axis=1))
    return frames


class _CountingProvider:
    """Flow = mean colour difference, so every pair and direction differs."""

    def __init__(self):
        self.calls, self.sizes = 0, []

    def compute_batch(self, a, b):
        self.calls += 1
        self.sizes.append(len(a))
        d = (b - a).mean(axis=-1, keepdims=True).astype(np.float32)
        return np.concatenate([d, -d], axis=-1)

    def compute_pair(self, im1, im2):
        both = self.compute_batch(np.stack([im1, im2]), np.stack([im2, im1]))
        return both[0], both[1]


def test_batched_flow_preprocess(five_frames, tmp_path):
    """pair_batch pairs x 2 directions per call: ceil(4/3) = 2 calls of 6
    and 2 images, the same 2*(T-1) files with the same contents as the
    per-pair branch, and a second run reuses them."""
    prov = _CountingProvider()
    paths = tengine.preprocess_optical_flow(five_frames, prov, verbose=False,
                                            pair_batch=3)
    assert len(paths) == 4 and prov.calls == 2 and prov.sizes == [6, 2]
    flow_dir = five_frames.parent / "vid_flow"
    batched = {p.name: np.load(p) for p in flow_dir.glob("*.npy")}
    assert len(batched) == 8
    assert all(v.shape == (32, 40, 2) and v.dtype == np.float32
               for v in batched.values())

    tengine.preprocess_optical_flow(five_frames, prov, verbose=False, pair_batch=3)
    assert prov.calls == 2                                    # idempotent

    import shutil

    shutil.rmtree(flow_dir)
    single = _CountingProvider()
    tengine.preprocess_optical_flow(five_frames, single, verbose=False,
                                    pair_batch=1)
    assert single.calls == 4 and single.sizes == [2] * 4
    per_pair = {p.name: np.load(p) for p in flow_dir.glob("*.npy")}
    assert per_pair.keys() == batched.keys()
    for k in batched:
        np.testing.assert_array_equal(per_pair[k], batched[k])


def test_preprocess_flow_cli_runs_raft(five_frames, model, tmp_path):
    """The CLI with a random `.pth` on the CPU writes RAFT's flow cache; with
    no checkpoint it falls back to Farneback."""
    from deflicker_torch.cli import preprocess_flow

    torch.save(model.state_dict(), tmp_path / "raft.pth")
    args = ["--vid_name", "vid", "--root", str(five_frames.parent)]
    assert preprocess_flow.main(args + ["--model", str(tmp_path / "raft.pth"),
                                        "--iters", "1"], device="cpu") == 0
    flows = sorted((five_frames.parent / "vid_flow").glob("*.npy"))
    assert len(flows) == 8
    assert all(np.isfinite(np.load(f)).all() for f in flows)
    assert np.load(flows[0]).shape == (32, 40, 2)
    assert preprocess_flow.main(args + ["--provider", "farneback"]) == 0


def test_flow_io_round_trips(tmp_path):
    from deflicker_tpu.io import flow_io as jio
    from deflicker_torch.io import flow_io as tio

    flow = np.random.default_rng(7).normal(0, 5, (9, 13, 2)).astype(np.float32)
    tio.write_flo(tmp_path / "a.flo", flow)
    np.testing.assert_array_equal(jio.read_flo(tmp_path / "a.flo"), flow)
    np.testing.assert_array_equal(tio.read_flo(tmp_path / "a.flo"), flow)
    tio.write_kitti_flow(tmp_path / "k.png", flow)
    got, valid = tio.read_kitti_flow(tmp_path / "k.png")
    assert valid.all() and np.abs(got - flow).max() <= 1 / 64
    tio.write_pfm(tmp_path / "p.pfm", flow[..., 0])
    np.testing.assert_array_equal(tio.read_pfm(tmp_path / "p.pfm")[0], flow[..., 0])
    np.testing.assert_array_equal(tio.flow_to_image(flow), jio.flow_to_image(flow))
    with pytest.raises(ValueError, match="not a .flo"):
        tio.read_flo(tmp_path / "k.png")
