"""Resuming a fit checkpoint the JAX package wrote: its optax Adam state
(`ScaleByAdamState`, `EmptyState`) loads as local stand-ins, maps by
structure into the port's Adam state, and the fit continues from it."""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deflicker_tpu.atlas import data as jdata
from deflicker_tpu.atlas import engine as jeng
from deflicker_tpu.config import AtlasConfig as JAtlasConfig
from deflicker_tpu.utils.checkpoint import save_checkpoint as jax_save

from deflicker_torch.atlas import data as tdata
from deflicker_torch.atlas import engine as teng
from deflicker_torch.config import AtlasConfig, PipelineConfig
from deflicker_torch.utils.checkpoint import (adam_state_from_optax,
                                              host_adam_state, load_checkpoint)
from deflicker_torch.utils.convert import atlas_params_from_jax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
T, H, W = 4, 24, 32
NARROW = dict(number_of_channels_atlas=32, number_of_layers_atlas=8,
              number_of_channels_mapping1=32, number_of_layers_mapping1=4,
              positional_encoding_num_atlas=6, samples_batch=96,
              fit_precision="highest")
TINY = dict(samples_batch=128, steps_per_call=10, pretrain_iter_number=2,
            number_of_channels_atlas=32, number_of_layers_atlas=4,
            number_of_channels_mapping1=32, number_of_layers_mapping1=3,
            number_of_channels_mapping2=32, number_of_layers_mapping2=3,
            number_of_channels_alpha=32, number_of_layers_alpha=3,
            stop_global_rigidity=5)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """test_torch_atlas.py's setup: frames, a flow cache, the pretrained JAX
    init, one batch of samples; plus one JAX Adam step saved with the JAX
    package's save_checkpoint, as its fit saves one."""
    import cv2

    root = tmp_path_factory.mktemp("resume") / "data"
    frames, flows = root / "vid", root / "vid_flow"
    frames.mkdir(parents=True)
    flows.mkdir()
    rng = np.random.default_rng(0)
    base = rng.uniform(30, 220, (H, W + T, 3))
    for t in range(T):
        cv2.imwrite(str(frames / f"{t:05d}.png"), base[:, t:t + W].astype(np.uint8))
    for t in range(T - 1):
        f12 = np.zeros((H, W, 2), np.float32)
        f12[..., 0] = -1.0 + 0.3 * rng.normal(size=(H, W))
        f21 = -f12 + 0.8 * rng.normal(size=(H, W, 2)).astype(np.float32)
        np.save(flows / f"{t:05d}.png_{t + 1:05d}.png.npy", f12)
        np.save(flows / f"{t + 1:05d}.png_{t:05d}.png.npy", f21)

    cfg_j = dataclasses.replace(JAtlasConfig(), **NARROW)
    cfg_t = dataclasses.replace(AtlasConfig(), **NARROW)
    d_j = jdata.load_video_data(frames, H, W, 200).with_packed()
    d_t = tdata.load_video_data(frames, H, W, 200)
    specs_j = jeng.build_specs(cfg_j, dual=False)
    params = jeng.init_models(jax.random.key(0), specs_j)
    params["mapping1"] = jeng.pretrain_mapping(
        params["mapping1"], specs_j.mapping1, jax.random.key(1), T, H, W,
        cfg_j.uv_mapping_scale, pretrain_iters=30, batch=512)
    samples = [tuple(r.integers(0, n, 96) for n in (W, H, T))
               for r in (np.random.default_rng(3), np.random.default_rng(4))]

    lf_j = jeng.make_loss_fn(specs_j, cfg_j, d_j, True, False)

    def grad_j(p, s):
        return jax.grad(lambda q: lf_j(q, d_j, *map(jnp.asarray, s))[0])(p)

    opt = optax.adam(cfg_j.learning_rate)
    state0 = opt.init(params)
    upd, state1 = opt.update(grad_j(params, samples[0]), state0, params)
    params1 = optax.apply_updates(params, upd)
    ckpt = jax_save(tmp_path_factory.mktemp("jax") / "checkpoint", {
        "params": params1, "opt_state": state1, "iteration": 1, "dual": False})
    upd, state2 = opt.update(grad_j(params1, samples[1]), state1, params1)
    params2 = optax.apply_updates(params1, upd)
    return dict(cfg_t=cfg_t, d_t=d_t, ckpt=ckpt, state1=state1,
                params2=_host(params2), samples=samples)


def test_optax_state_maps_exactly(setup):
    """Step and moments after the mapping equal the JAX package's numpy
    arrays bit for bit, in `flat_params` order (networks by name, layers,
    w then b)."""
    ck = load_checkpoint(setup["ckpt"])
    state = host_adam_state(ck["opt_state"], ck["params"])
    adam = setup["state1"][0]
    assert state["step"] == 1 == int(adam.count)
    want_m, want_v = [], []
    for name in sorted(ck["params"]):
        for lm, lv in zip(adam.mu[name], adam.nu[name]):
            for k in ("w", "b"):
                want_m.append(np.asarray(lm[k]))
                want_v.append(np.asarray(lv[k]))
    assert len(state["exp_avg"]) == len(want_m) == 2 * (4 + 8)
    for got, want in zip(state["exp_avg"] + state["exp_avg_sq"], want_m + want_v):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # the port's own state passes through; None stays None
    assert host_adam_state(state, ck["params"]) is state
    assert host_adam_state(None, ck["params"]) is None


def test_second_step_from_resumed_state_matches_jax(setup):
    """The port resumes params and Adam state from the JAX checkpoint and
    takes the second step on the same samples with its own gradients:
    params within 2e-6 absolute of JAX's second step (the bound of
    test_torch_atlas.py::test_one_adam_step_matches)."""
    ck = load_checkpoint(setup["ckpt"])
    cfg = setup["cfg_t"]
    specs = teng.build_specs(cfg)
    p = atlas_params_from_jax(ck["params"])
    opt = teng.make_optimizer(p, cfg.learning_rate)
    teng.adam_state_from_host(opt, p, host_adam_state(ck["opt_state"],
                                                      ck["params"]))
    lf = teng.make_loss_fn(specs, cfg, setup["d_t"], True)
    lf(p, setup["d_t"].with_packed().packed,
       *map(torch.tensor, setup["samples"][1]))[0].backward()
    opt.step()
    assert int(opt.state[p["atlas"][0]["w"]]["step"]) == 2
    for net in ("mapping1", "atlas"):
        for lt, lj in zip(p[net], setup["params2"][net]):
            for key in ("w", "b"):
                np.testing.assert_allclose(lt[key].detach().numpy(), lj[key],
                                           atol=2e-6)


@pytest.mark.parametrize("kind", ["dual", "group"])
def test_dual_and_group_states_map_by_structure(kind, tmp_path):
    """The dual fit's four networks and a group fit's video axis (count one
    per video): each moment lands on its own parameter, whatever order the
    pickle holds the networks in."""
    cfg = dataclasses.replace(JAtlasConfig(), **TINY)
    specs = jeng.build_specs(cfg, dual=kind == "dual")
    opt = optax.adam(1e-3)
    if kind == "group":
        keys = jax.random.split(jax.random.key(0), 2)
        params = jax.vmap(lambda k: jeng.init_models(k, specs))(keys)
        state = jax.vmap(opt.init)(params)
        grads = jax.tree_util.tree_map(lambda x: 0.1 * x + 0.01, params)
        _, state = jax.vmap(opt.update)(grads, state, params)
    else:
        params = jeng.init_models(jax.random.key(0), specs)
        grads = jax.tree_util.tree_map(lambda x: 0.1 * x + 0.01, params)
        _, state = opt.update(grads, opt.init(params), params)
    host = _host({"params": params, "opt_state": state})
    # networks in another order than sorted: the mapping must not care
    host["params"] = dict(reversed(list(host["params"].items())))
    path = tmp_path / "checkpoint"
    path.write_bytes(pickle.dumps(host, protocol=pickle.HIGHEST_PROTOCOL))
    ck = load_checkpoint(path)
    got = adam_state_from_optax(ck["opt_state"], ck["params"])
    assert got["step"] == 1
    flat = teng.flat_params(atlas_params_from_jax(ck["params"]))
    assert len(flat) == len(got["exp_avg"])
    mu = host["opt_state"][0].mu
    want = [np.asarray(layer[k]) for name in sorted(mu) for layer in mu[name]
            for k in ("w", "b")]
    for p, m, w in zip(flat, got["exp_avg"], want):
        assert tuple(p.shape) == m.shape
        np.testing.assert_array_equal(m, w)
    if kind == "dual":
        assert sorted(ck["params"]) == ["alpha", "atlas", "mapping1", "mapping2"]
    else:
        assert all(m.shape[0] == 2 for m in got["exp_avg"])
    bad = dict(ck["params"])
    bad.pop("atlas")
    with pytest.raises(ValueError, match="moments"):
        adam_state_from_optax(ck["opt_state"], bad)


@pytest.fixture
def tiny_clip(tmp_path):
    import cv2

    frames = tmp_path / "data" / "vid"
    frames.mkdir(parents=True)
    rng = np.random.default_rng(0)
    base = rng.uniform(40, 215, (48, 64, 3)).astype(np.uint8)
    for t in range(5):
        f = np.clip(np.roll(base, t, axis=1).astype(np.float32)
                    * (1.0 + 0.1 * ((-1) ** t)), 0, 255)
        cv2.imwrite(str(frames / f"{t:05d}.png"), f.astype(np.uint8))
    return tmp_path, frames


def _one_jax_step(params, lr):
    opt = optax.adam(lr)
    grads = jax.tree_util.tree_map(lambda x: 0.1 * x + 0.01, params)
    if jax.tree_util.tree_leaves(params)[0].ndim == 3:       # video axis
        upd, state = jax.vmap(opt.update)(grads, jax.vmap(opt.init)(params),
                                          params)
    else:
        upd, state = opt.update(grads, opt.init(params), params)
    return optax.apply_updates(params, upd), state


def test_run_stage1_resumes_a_jax_checkpoint(tiny_clip):
    """`run_stage1` resumes a tiny JAX-written single-fit checkpoint at its
    iteration (1) and runs on to iters_num (11): 10 iterations, and the
    port's checkpoint then holds Adam step 11 in its own form."""
    from deflicker_torch.cli.pipeline import run_stage1

    tmp, frames = tiny_clip
    cfg_j = dataclasses.replace(JAtlasConfig(), **TINY)
    specs = jeng.build_specs(cfg_j, dual=False)
    params, state = _one_jax_step(jeng.init_models(jax.random.key(0), specs),
                                  cfg_j.learning_rate)
    ckpt = jax_save(tmp / "jax.ckpt", {"params": params, "opt_state": state,
                                       "iteration": 1, "dual": False})
    atlas_cfg = dataclasses.replace(
        AtlasConfig(), **TINY, iters_num=11, evaluate_every=10,
        load_checkpoint=True, checkpoint_path=str(ckpt))
    cfg = PipelineConfig(video_frame_folder=str(frames), root=str(frames.parent),
                         results_root=str(tmp / "results"), down=2,
                         ckpt_raft=str(tmp / "missing.pth"))
    out = run_stage1(frames, cfg, atlas_cfg, "cpu")
    assert out["iterations"] == 10 and out["t_pretrain"] == 0.0
    assert np.isfinite(out["psnr"])
    saved = load_checkpoint(tmp / "results" / "vid" / "stage_1" / "checkpoint")
    assert isinstance(saved["opt_state"], dict)
    assert saved["opt_state"]["step"] == 11


def test_chunked_fit_resumes_a_jax_group_checkpoint(tiny_clip, capsys):
    """A JAX group checkpoint (params_v, opt_state_v, key_data) of the same
    chunking resumes the chunked fit at its iteration with its params and
    moments; its PRNG state cannot be replayed, which one line says."""
    from deflicker_torch.cli.pipeline import _chunk_starts, run_stage1

    tmp, frames = tiny_clip
    size, starts = _chunk_starts(5, 3)
    cfg_j = dataclasses.replace(JAtlasConfig(), **TINY)
    specs = jeng.build_specs(cfg_j, dual=False)
    keys = jax.random.split(jax.random.key(0), len(starts))
    params_v, state_v = _one_jax_step(
        jax.vmap(lambda k: jeng.init_models(k, specs))(keys), cfg_j.learning_rate)
    ckpt = jax_save(tmp / "group.ckpt", {
        "params_v": params_v, "opt_state_v": state_v,
        "key_data": np.asarray(jax.random.key_data(keys)), "iteration": 1,
        "chunk_starts": starts, "chunk_size": size, "dual": False})
    atlas_cfg = dataclasses.replace(
        AtlasConfig(), **TINY, iters_num=6, evaluate_every=5,
        maximum_number_of_frames=3, load_checkpoint=True,
        checkpoint_path=str(ckpt))
    cfg = PipelineConfig(video_frame_folder=str(frames), root=str(frames.parent),
                         results_root=str(tmp / "results"), down=2,
                         ckpt_raft=str(tmp / "missing.pth"))
    out = run_stage1(frames, cfg, atlas_cfg, "cpu")
    assert out["chunks"] == 2 and out["iterations"] == 5
    assert capsys.readouterr().out.count("cannot be replayed") == 1
    saved = load_checkpoint(tmp / "results" / "vid" / "stage_1" / "checkpoint")
    assert saved["opt_state_v"]["step"] == 6 and saved["iteration"] == 6


def test_other_classes_are_still_refused(tmp_path):
    """A checkpoint naming any class but the two optax states is refused:
    another optax state, and raw JAX arrays (pickled without to_host)."""
    sched = optax.scale_by_schedule(lambda n: 1.0).init({"w": np.zeros(2)})
    for i, tree in enumerate((_host({"opt_state": sched}),
                              {"opt_state": optax.adam(1e-3).init(
                                  {"w": jnp.zeros(2)})})):
        path = tmp_path / f"c{i}"
        path.write_bytes(pickle.dumps(tree))
        with pytest.raises(pickle.UnpicklingError, match="checkpoint holds"):
            load_checkpoint(path)


def test_loading_a_jax_checkpoint_imports_no_optax(setup):
    """The stand-ins load the JAX checkpoint in a fresh interpreter without
    importing optax, JAX or the JAX package."""
    code = (
        "import sys\n"
        "from deflicker_torch.utils.checkpoint import load_checkpoint, host_adam_state\n"
        f"c = load_checkpoint({str(setup['ckpt'])!r})\n"
        "s = host_adam_state(c['opt_state'], c['params'])\n"
        "assert s['step'] == 1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'optax', 'flax', 'deflicker_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")
