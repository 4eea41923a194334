"""Port vs JAX package: stage-1 data loading, the fit loss (same samples,
same converted params), one Adam step, and the fit loop's cadence."""

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
from deflicker_torch.config import AtlasConfig
from deflicker_torch.utils.checkpoint import load_checkpoint
from deflicker_torch.utils.convert import atlas_params_from_jax

torch.set_num_threads(2)

T, H, W = 4, 24, 32
NARROW = dict(number_of_channels_atlas=32, number_of_layers_atlas=8,
              number_of_channels_mapping1=32, number_of_layers_mapping1=4,
              positional_encoding_num_atlas=6, samples_batch=96,
              fit_precision="highest")


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """Frames plus a flow cache in the reference's layout."""
    import cv2

    root = tmp_path_factory.mktemp("atlas") / "data"
    frames = root / "vid"
    flows = root / "vid_flow"
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
    cfg_t = dataclasses.replace(AtlasConfig(), **NARROW)
    cfg_j = dataclasses.replace(JAtlasConfig(), **NARROW)
    d_j = jdata.load_video_data(video_dir, H, W, 200).with_packed()
    d_t = tdata.load_video_data(video_dir, H, W, 200)
    specs_j = jeng.build_specs(cfg_j, dual=False)
    params = jeng.init_models(jax.random.key(0), specs_j)
    # the pretrained regime: a random mapping makes the rigidity Jacobian
    # near-singular and its gradients ill-conditioned for any comparison
    params["mapping1"] = jeng.pretrain_mapping(
        params["mapping1"], specs_j.mapping1, jax.random.key(1), T, H, W,
        cfg_j.uv_mapping_scale, pretrain_iters=30, batch=512)
    host = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(3)
    jif = (rng.integers(0, W, 96), rng.integers(0, H, 96),
           rng.integers(0, T, 96))
    return cfg_j, cfg_t, d_j, d_t, specs_j, params, host, jif


def test_load_video_data_matches(setup):
    _, _, d_j, d_t, *_ = setup
    for name in ("video", "dx", "dy", "mask", "flow_fwd", "flow_bwd",
                 "mask_fwd", "mask_bwd"):
        np.testing.assert_array_equal(getattr(d_t, name),
                                      np.asarray(getattr(d_j, name)), name)
    assert 0 < d_t.mask_fwd[:-1].mean() < 1
    np.testing.assert_array_equal(d_t.with_packed().packed.numpy(),
                                  np.asarray(d_j.packed))


@pytest.mark.parametrize("include_global", [True, False])
def test_loss_and_grads_match(setup, include_global):
    """Same (j, i, f) samples and converted params through both loss
    functions at fit_precision="highest" (plain f32 on both sides): the
    total, every aux term (rtol 1e-4: f32 summation order) and every
    parameter gradient (relative Frobenius 1e-3: the rigidity inverse
    amplifies rounding, see test_torch_losses)."""
    cfg_j, cfg_t, d_j, d_t, specs_j, params, host, (j, i, f) = setup
    lf_j = jeng.make_loss_fn(specs_j, cfg_j, d_j, include_global, False)
    (tot_j, aux_j), g_j = jax.value_and_grad(lf_j, has_aux=True)(
        params, d_j, jnp.asarray(j), jnp.asarray(i), jnp.asarray(f))

    specs_t = teng.build_specs(cfg_t)
    p_t = atlas_params_from_jax(host)
    lf_t = teng.make_loss_fn(specs_t, cfg_t, d_t, include_global)
    tot_t, aux_t = lf_t(p_t, d_t.with_packed().packed, torch.tensor(j),
                        torch.tensor(i), torch.tensor(f))
    tot_t.backward()
    assert set(aux_t) == set(aux_j)
    for k in aux_j:
        np.testing.assert_allclose(aux_t[k].item(), float(aux_j[k]),
                                   rtol=1e-4, err_msg=k)
    for net in ("mapping1", "atlas"):
        for lt, lj in zip(p_t[net], g_j[net]):
            for key in ("w", "b"):
                a, b = lt[key].grad.numpy(), np.asarray(lj[key])
                rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
                assert rel < 1e-3, (net, key, rel)


def test_one_adam_step_matches(setup):
    """optax.adam and the port's Adam (optax defaults) from the same params
    and each package's own gradients: one step moves every param by about
    lr, so params agree to 2e-6 absolute (the first step is lr * g/|g|
    where |g| > eps; gradient rounding shifts it only where |g| ~ eps)."""
    cfg_j, cfg_t, d_j, d_t, specs_j, params, host, (j, i, f) = setup
    lf_j = jeng.make_loss_fn(specs_j, cfg_j, d_j, True, False)
    g_j = jax.grad(lambda p: lf_j(p, d_j, jnp.asarray(j), jnp.asarray(i),
                                  jnp.asarray(f))[0])(params)
    opt = optax.adam(cfg_j.learning_rate)
    upd, _ = opt.update(g_j, opt.init(params), params)
    new_j = optax.apply_updates(params, upd)

    specs_t = teng.build_specs(cfg_t)
    p_t = atlas_params_from_jax(host)
    lf_t = teng.make_loss_fn(specs_t, cfg_t, d_t, True)
    o_t = teng.make_optimizer(p_t, cfg_t.learning_rate)
    lf_t(p_t, d_t.with_packed().packed, torch.tensor(j), torch.tensor(i),
         torch.tensor(f))[0].backward()
    o_t.step()
    for net in ("mapping1", "atlas"):
        for lt, lj in zip(p_t[net], new_j[net]):
            for key in ("w", "b"):
                np.testing.assert_allclose(lt[key].detach().numpy(),
                                           np.asarray(lj[key]), atol=2e-6)


def test_fit_cadence_logs_and_eval(setup):
    """Chunks end at steps_per_call, the global-rigidity boundary and the
    eval point, with one log record per chunk; the eval fires once at
    iteration 10 (i % evaluate_every == 0, i > start)."""
    _, cfg_t, _, d_t, _, _, host, _ = setup
    cfg = dataclasses.replace(cfg_t, iters_num=12, steps_per_call=5,
                              stop_global_rigidity=6, evaluate_every=10,
                              fit_precision="default")
    specs = teng.build_specs(cfg)
    p = atlas_params_from_jax(host)
    evals = []
    res = teng.fit_atlas(p, specs, d_t, cfg, torch.Generator().manual_seed(0),
                         eval_callback=lambda i, pp, o: evals.append(i))
    assert [r["iteration"] for r in res.logs] == [4, 6, 10, 11]
    assert "global_rigidity1" in res.logs[1]
    assert "global_rigidity1" not in res.logs[2]
    assert evals == [10] and res.iteration == 12
    assert res.opt_state["step"] == 12
    assert all(np.isfinite(r["total"]) for r in res.logs)


def test_non_finite_loss_dumps_rescue(setup, tmp_path):
    _, cfg_t, _, d_t, _, _, host, _ = setup
    cfg = dataclasses.replace(cfg_t, iters_num=3, steps_per_call=3,
                              rgb_coeff=float("nan"))
    specs = teng.build_specs(cfg)
    rescue = tmp_path / "rescue"
    with pytest.raises(FloatingPointError):
        teng.fit_atlas(atlas_params_from_jax(host), specs, d_t, cfg,
                       torch.Generator().manual_seed(0), rescue_path=str(rescue))
    ck = load_checkpoint(rescue)
    assert ck["iteration"] == 3 and set(ck["params"]) == {"mapping1", "atlas"}


def test_select_imlp_apply_routes(monkeypatch):
    from deflicker_torch.models.imlp import imlp_apply, imlp_apply_fused

    monkeypatch.delenv("DEFLICKER_IMLP_STASH", raising=False)
    assert teng.select_imlp_apply(True, "default") is imlp_apply_fused
    assert teng.select_imlp_apply(True, "highest") is imlp_apply
    assert teng.select_imlp_apply(False, "default") is imlp_apply
    # the dual specs build: mapping2 and alpha beside mapping1 and the atlas
    single, dual = teng.build_specs(AtlasConfig()), teng.build_specs(
        AtlasConfig(), dual=True)
    assert not single.dual and single.mapping2 is None and single.alpha is None
    assert dual.dual and dual[:2] == single[:2]
    assert dual.mapping2.num_layers == 4 and dual.alpha.output_dim == 1


def test_resume_from_host_state_continues_the_fit(setup):
    """Params and Adam state saved as plain numpy (the port's checkpoint
    form) resume the fit: 3 + 3 steps equal 6 straight steps (same sample
    stream; CPU f32, so equal to rounding: atol 1e-6)."""
    from deflicker_torch.utils.checkpoint import to_host

    _, cfg_t, _, d_t, _, _, host, _ = setup
    cfg = dataclasses.replace(cfg_t, steps_per_call=3, evaluate_every=100)
    specs = teng.build_specs(cfg)
    straight = teng.fit_atlas(atlas_params_from_jax(host), specs, d_t,
                              dataclasses.replace(cfg, iters_num=6),
                              torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(1)
    half = teng.fit_atlas(atlas_params_from_jax(host), specs, d_t,
                          dataclasses.replace(cfg, iters_num=3), gen)
    resumed = teng.fit_atlas(atlas_params_from_jax(to_host(half.params)), specs,
                             d_t, dataclasses.replace(cfg, iters_num=6), gen,
                             start_iteration=3, opt_state=half.opt_state)
    assert resumed.iteration == 6 and resumed.opt_state["step"] == 6
    for net in ("mapping1", "atlas"):
        for a, b in zip(straight.params[net], resumed.params[net]):
            np.testing.assert_allclose(a["w"].detach().numpy(),
                                       b["w"].detach().numpy(), atol=1e-6)
