"""Port vs JAX package: the multi-video fit — the chain with a video axis,
the V-batched loss (every schedule phase, single and dual), one Adam step
over stacked videos, and the multi-fit's plumbing (grouping, stacking,
chunk starts, resume, the batched pretrain, the eval cadence)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflicker_tpu.atlas import data as jdata
from deflicker_tpu.atlas import engine as jeng
from deflicker_tpu.cli.pipeline import _chunk_starts as j_chunk_starts
from deflicker_tpu.config import AtlasConfig as JAtlasConfig
from deflicker_tpu.models import imlp as jimlp
from deflicker_tpu.ops.pallas.imlp_kernel import fused_imlp_linear_chain as jchain

from deflicker_torch.atlas import data as tdata
from deflicker_torch.atlas import engine as teng
from deflicker_torch.atlas import multifit as tmulti
from deflicker_torch.cli.pipeline import _chunk_starts
from deflicker_torch.config import AtlasConfig
from deflicker_torch.models import imlp as timlp
from deflicker_torch.ops.cuda import imlp_kernel as K
from deflicker_torch.utils.checkpoint import to_host
from deflicker_torch.utils.convert import atlas_params_from_jax

torch.set_num_threads(2)

V, T, H, W = 2, 4, 24, 32
NETS = ("mapping1", "mapping2", "atlas", "alpha")
NARROW = dict(number_of_channels_atlas=32, number_of_layers_atlas=4,
              number_of_channels_mapping1=32, number_of_layers_mapping1=4,
              number_of_channels_mapping2=32, number_of_layers_mapping2=3,
              number_of_channels_alpha=32, number_of_layers_alpha=4,
              positional_encoding_num_atlas=6, samples_batch=96,
              global_rigidity_derivative_amount_fg=5,
              global_rigidity_derivative_amount_bg=7,
              fit_precision="highest")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _write_clip(root, seed):
    """Frames, a flow cache and `_seg` masks in the reference's layout."""
    import cv2

    frames, flows, seg = root / "vid", root / "vid_flow", root / "vid_seg"
    for d in (frames, flows, seg):
        d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    base = rng.uniform(30, 220, (H, W + T, 3))
    for t in range(T):
        cv2.imwrite(str(frames / f"{t:05d}.png"), base[:, t:t + W].astype(np.uint8))
        m = np.zeros((H, W), np.uint8)
        m[H // 4:H // 4 * 3, W // 4 + t:W // 2 + t] = 255
        cv2.imwrite(str(seg / f"{t:05d}.png"), m)
    for t in range(T - 1):
        f12 = np.zeros((H, W, 2), np.float32)
        f12[..., 0] = -1.0 + 0.3 * rng.normal(size=(H, W))
        f21 = -f12 + 0.8 * rng.normal(size=(H, W, 2)).astype(np.float32)
        np.save(flows / f"{t:05d}.png_{t + 1:05d}.png.npy", f12)
        np.save(flows / f"{t + 1:05d}.png_{t:05d}.png.npy", f21)
    return frames


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two same-shaped dual clips, both packages' data, and per-video JAX
    params with pretrained mappings (a random mapping makes the rigidity
    Jacobian near-singular and its gradients ill-conditioned for any
    comparison), stacked on a video axis."""
    cfg_t = dataclasses.replace(AtlasConfig(), **NARROW)
    cfg_j = dataclasses.replace(JAtlasConfig(), **NARROW)
    specs_j = jeng.build_specs(cfg_j, dual=True)
    d_j, d_t, hosts = [], [], []
    for v in range(V):
        frames = _write_clip(tmp_path_factory.mktemp(f"multi{v}") / "data", v)
        d_j.append(jdata.load_video_data(frames, H, W, 200, use_masks=True)
                   .with_packed())
        d_t.append(tdata.load_video_data(frames, H, W, 200, use_masks=True))
        params = jeng.init_models(jax.random.key(v), specs_j)
        for k, net in enumerate(("mapping1", "mapping2")):
            params[net] = jeng.pretrain_mapping(
                params[net], getattr(specs_j, net), jax.random.key(10 * v + k),
                T, H, W, cfg_j.uv_mapping_scale, pretrain_iters=30, batch=512)
        hosts.append(jax.tree_util.tree_map(np.asarray, params))
    stacked = jax.tree_util.tree_map(lambda *x: np.stack(x), *hosts)
    # a draw whose gradients are well conditioned for both videos: the
    # one-video comparison of test_torch_atlas on these params ranges from
    # 5e-4 to 3e-3 over draws (the rigidity inverse amplifies rounding),
    # so the draw, not the video axis, decides whether 1e-3 holds
    rng = np.random.default_rng(11)
    jif = (rng.integers(0, W, (V, 96)), rng.integers(0, H, (V, 96)),
           rng.integers(0, T, (V, 96)))
    return cfg_j, cfg_t, d_j, d_t, specs_j, hosts, stacked, jif


def _subset(tree, dual):
    return {k: v for k, v in tree.items()
            if dual or k in ("mapping1", "atlas")}


# ---------------------------------------------------------------------------
# the chain with a video axis
# ---------------------------------------------------------------------------

CHAIN = dict(input_dim=2, output_dim=3, hidden_dim=32, use_positional=True,
             positional_dim=4, num_layers=5, skip_layers=(3,))


def _chain_operands(n_videos, B, seed=0):
    spec = timlp.IMLPSpec(**CHAIN)
    params = timlp.imlp_init(spec, torch.Generator().manual_seed(seed),
                             n_videos=n_videos)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n_videos, B, 2)).astype(np.float32)
    g = rng.normal(size=(n_videos, B, 3)).astype(np.float32)
    xe = timlp.positional_encoding(torch.from_numpy(x), spec.positional_dim)
    ws = [p["w"].detach() for p in params]
    bs = [p["b"].detach() for p in params]
    return spec, params, x, xe, ws, bs, torch.from_numpy(g)


def test_video_axis_twins_equal_per_video_calls():
    """Both plain pairs with V = 3 are bit-equal to V one-video calls."""
    _, _, _, xe, ws, bs, g = _chain_operands(3, 70)
    sk = CHAIN["skip_layers"]
    y = K.imlp_chain_fwd_plain(xe, ws, bs, sk)
    dx, dW, db = K.imlp_chain_bwd_plain(xe, ws, bs, sk, g, True)
    ys, stash = K.imlp_chain_fwd_stash_plain(xe, ws, bs, sk)
    sdx, sdW, sdb = K.imlp_chain_bwd_stash_plain(xe, ws, bs, sk, stash, g, True)
    assert y.shape == (3, 70, 3) and torch.equal(y, ys)
    for v in range(3):
        wv, bv = [w[v] for w in ws], [b[v] for b in bs]
        assert torch.equal(y[v], K.imlp_chain_fwd_plain(xe[v], wv, bv, sk))
        one = K.imlp_chain_bwd_plain(xe[v], wv, bv, sk, g[v], True)
        for a, b in zip([dx] + dW + db, [one[0]] + one[1] + one[2]):
            assert torch.equal(a[v], b)
        _, st1 = K.imlp_chain_fwd_stash_plain(xe[v], wv, bv, sk)
        assert all(torch.equal(a[v], b) for a, b in zip(stash, st1))
    for a, b in zip([sdx] + sdW + sdb, [dx] + dW + db):
        assert torch.equal(a, b)


@pytest.mark.parametrize("stash", [False, True])
def test_video_axis_chain_matches_vmapped_pallas(stash):
    """The port's chain on stacked params (plain twins, through autograd)
    vs `jax.vmap` of the Pallas chain in interpret mode (bf16 compute, the
    production bodies): output, parameter and input gradients within the
    chain's bounds (relative Frobenius 5e-3 output, 2e-2 gradients: both
    round the same operands to bf16 and sum in f32 in other orders)."""
    spec, params, x, _, _, _, g = _chain_operands(3, 150, seed=4)
    jspec = jimlp.IMLPSpec(**CHAIN)
    jparams = [{k: jnp.asarray(p[k].detach().numpy()) for k in ("w", "b")}
               for p in params]
    tgt = g.numpy()

    def one(p, xx, tt):
        xe = jimlp.positional_encoding(xx, jspec.positional_dim)
        y = jnp.tanh(jchain(p, xe, jspec, tile=128, interpret=True,
                            compute_dtype=jnp.bfloat16, v2=True, pipe=True,
                            stash_bwd=stash))
        return jnp.sum(y * tt), y

    (_, y_j), (gp_j, gx_j) = jax.vmap(
        jax.value_and_grad(one, argnums=(0, 1), has_aux=True))(
            jparams, jnp.asarray(x), jnp.asarray(tgt))
    xt = torch.from_numpy(x).requires_grad_()
    y_t = timlp.imlp_apply_fused(params, xt, spec, stash_bwd=stash)
    (y_t * g).sum().backward()
    assert _rel(y_t.detach().numpy(), y_j) < 5e-3
    assert _rel(xt.grad.numpy(), gx_j) < 2e-2
    for lt, lj in zip(params, gp_j):
        for k in ("w", "b"):
            assert _rel(lt[k].grad.numpy(), lj[k]) < 2e-2, k


# ---------------------------------------------------------------------------
# the V-batched loss and one Adam step
# ---------------------------------------------------------------------------

PHASES = [(True, False, True), (True, False, False), (True, True, True),
          (True, True, False), (False, False, True), (False, False, False)]


@pytest.mark.parametrize("dual,include_global,include_bootstrap", PHASES)
def test_video_axis_loss_matches_vmapped_jax(setup, dual, include_global,
                                             include_bootstrap):
    """The port's loss on stacked params, packs (V, T, H, W, 16) and samples
    (V, B) against `jax.vmap` of the JAX package's loss, at
    fit_precision="highest" (plain f32 on both sides), in all four dual
    phases and both single ones: per-video total and aux terms (rtol 1e-4,
    f32 summation order) and every parameter gradient of the summed loss
    (relative Frobenius 1e-3 per video: the rigidity inverse amplifies
    rounding, see test_torch_atlas)."""
    cfg_j, cfg_t, d_j, d_t, _, _, stacked, (j, i, f) = setup
    specs_j = jeng.build_specs(cfg_j, dual=dual)
    lf_j = jeng.make_loss_fn(specs_j, cfg_j, d_j[0], include_global,
                             include_bootstrap)
    data_v = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *d_j)
    p_j = jax.tree_util.tree_map(jnp.asarray, _subset(stacked, dual))

    def total(p):
        tot, aux = jax.vmap(lf_j)(p, data_v, jnp.asarray(j), jnp.asarray(i),
                                  jnp.asarray(f))
        return jnp.sum(tot), aux

    (_, aux_j), g_j = jax.value_and_grad(total, has_aux=True)(p_j)

    specs_t = teng.build_specs(cfg_t, dual=dual)
    p_t = atlas_params_from_jax(_subset(stacked, dual))
    lf_t = teng.make_loss_fn(specs_t, cfg_t, d_t[0], include_global,
                             include_bootstrap)
    packed = tmulti.stack_video_data(d_t).packed
    tot_t, aux_t = lf_t(p_t, packed, torch.tensor(j), torch.tensor(i),
                        torch.tensor(f))
    tot_t.sum().backward()
    assert tot_t.shape == (V,) and set(aux_t) == set(aux_j)
    for k in aux_j:
        np.testing.assert_allclose(aux_t[k].detach().numpy(),
                                   np.asarray(aux_j[k]), rtol=1e-4, err_msg=k)
    for net in p_t:
        for lt, lj in zip(p_t[net], g_j[net]):
            for key in ("w", "b"):
                for v in range(V):
                    rel = _rel(lt[key].grad[v].numpy(), np.asarray(lj[key])[v])
                    assert rel < 1e-3, (net, key, v, rel)


@pytest.mark.parametrize("dual", [False, True])
def test_one_adam_step_of_two_videos_equals_two_single_steps(setup, dual):
    """One torch.optim.Adam over the stacked (V, ...) tensors is V
    independent Adams (Adam is elementwise and d(sum_v loss_v)/d(theta_v) =
    d(loss_v)/d(theta_v)): one step of V = 2 equals one single-video step
    per video on the same samples, to f32 rounding (atol 1e-7; the steps
    are about lr = 1e-4)."""
    _, cfg_t, _, d_t, _, hosts, stacked, (j, i, f) = setup
    cfg = dataclasses.replace(cfg_t, fit_precision="default")
    specs = teng.build_specs(cfg, dual=dual)
    p_v = atlas_params_from_jax(_subset(stacked, dual))
    lf = teng.make_loss_fn(specs, cfg, d_t[0], True, dual)
    opt = teng.make_optimizer(p_v, cfg.learning_rate)
    packed = tmulti.stack_video_data(d_t).packed
    lf(p_v, packed, torch.tensor(j), torch.tensor(i),
       torch.tensor(f))[0].sum().backward()
    opt.step()
    for v in range(V):
        p1 = atlas_params_from_jax(_subset(hosts[v], dual))
        o1 = teng.make_optimizer(p1, cfg.learning_rate)
        lf(p1, d_t[v].with_packed().packed, torch.tensor(j[v]),
           torch.tensor(i[v]), torch.tensor(f[v]))[0].backward()
        o1.step()
        for net in p1:
            for a, b in zip(p_v[net], p1[net]):
                for k in ("w", "b"):
                    np.testing.assert_allclose(a[k][v].detach().numpy(),
                                               b[k].detach().numpy(), atol=1e-7)


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------

def test_group_by_shape_and_stack_reject_mixed_shapes(setup):
    _, _, _, d_t, *_ = setup
    short = d_t[0]._replace(**{k: np.asarray(getattr(d_t[0], k))[:3]
                               for k in tdata.VideoData._fields[:-1]})
    groups = tmulti.group_by_shape([d_t[0], short, d_t[1]])
    assert groups == {(T, H, W): [0, 2], (3, H, W): [1]}
    with pytest.raises(ValueError, match="differing shapes"):
        tmulti.stack_video_data([d_t[0], short])
    data_v = tmulti.stack_video_data(d_t)
    assert data_v.packed.shape == (V, T, H, W, 16)
    assert data_v.video.shape == (V, T, H, W, 3)
    assert tmulti.first_video(data_v).num_frames == T


@pytest.mark.parametrize("T_all,cap", [(7, 3), (6, 3), (200, 200), (201, 200),
                                       (170, 80), (5, 3)])
def test_chunk_starts_match_jax(T_all, cap):
    """Equal chunks, the last anchored backward: the table of
    tests/test_pipeline.py and the chip-smoke clip (170 frames, cap 80 ->
    3 chunks of 57 at 0, 57, 113)."""
    assert _chunk_starts(T_all, cap) == j_chunk_starts(T_all, cap)
    if (T_all, cap) == (170, 80):
        assert _chunk_starts(T_all, cap) == (57, [0, 57, 113])


def _tiny_fit_cfg(cfg_t, **kw):
    return dataclasses.replace(cfg_t, fit_precision="default", iters_num=6,
                               steps_per_call=2, evaluate_every=3,
                               stop_global_rigidity=3, **kw)


def test_resume_replays_the_uninterrupted_fit(setup):
    """Stop the group fit at its eval point (params, Adam moments and the
    generator's state through the checkpoint callback, as plain numpy), and
    resume: the final params and the logs equal the uninterrupted fit's bit
    for bit (same device code, same sample stream)."""
    _, cfg_t, _, d_t, _, _, stacked, _ = setup
    cfg = _tiny_fit_cfg(cfg_t)
    specs = teng.build_specs(cfg)
    data_v = tmulti.stack_video_data(d_t)
    saved = {}

    def ckpt(iteration, state):
        if iteration < cfg.iters_num and not saved:
            saved.update(to_host(state), iteration=iteration)

    full = tmulti.fit_atlas_multi(atlas_params_from_jax(_subset(stacked, False)),
                                  specs, data_v, cfg,
                                  torch.Generator().manual_seed(7),
                                  checkpoint_callback=ckpt)
    assert saved["iteration"] == 4          # eval at last = 3, resume at i = 4
    gen = torch.Generator()
    gen.set_state(torch.as_tensor(saved["generator_state"]))
    resumed = tmulti.fit_atlas_multi(
        atlas_params_from_jax(saved["params_v"]), specs, data_v, cfg, gen,
        start_iteration=saved["iteration"], opt_state_v=saved["opt_state_v"])
    for v in range(V):
        assert resumed[v].iteration == full[v].iteration == 6
        assert resumed[v].logs == full[v].logs[-len(resumed[v].logs):]
        for net in ("mapping1", "atlas"):
            for a, b in zip(full[v].params[net], resumed[v].params[net]):
                assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
        assert resumed[v].opt_state["step"] == 6


def test_pretrain_multi_matches_per_video_pretrains(setup):
    """The batched pretrain equals `pretrain_mapping`'s recipe run per
    video on the same samples (drawn once, (V, batch) per step): plain f32
    on both sides, so to f32 rounding (atol 1e-6)."""
    _, cfg_t, *_ = setup
    spec = teng.build_specs(cfg_t).mapping1
    params_v = timlp.imlp_init(spec, torch.Generator().manual_seed(0), n_videos=V)
    singles = [[{k: p[k].detach()[v].clone().requires_grad_() for k in ("w", "b")}
                for p in params_v] for v in range(V)]
    tmulti.pretrain_mapping_multi(params_v, spec, torch.Generator().manual_seed(3),
                                  T, H, W, cfg_t.uv_mapping_scale,
                                  pretrain_iters=2, batch=50)
    gen = torch.Generator().manual_seed(3)
    opts = [teng._adam([l[k] for l in p for k in ("w", "b")], 1e-4)
            for p in singles]
    for _ in range(2):
        for f in range(T):
            i, j = tmulti.pretrain_samples(gen, V, 50, H, W, "cpu")
            for v in range(V):
                xyt = teng.normalize_xyt(j[v], i[v], torch.full((50,), f),
                                         max(H, W), T)
                uv = timlp.imlp_apply(singles[v], xyt, spec)
                loss = torch.mean(teng.safe_norm(xyt[:, :2] * cfg_t.uv_mapping_scale
                                                 - uv))
                opts[v].zero_grad()
                loss.backward()
                opts[v].step()
    for v in range(V):
        for a, b in zip(params_v, singles[v]):
            np.testing.assert_allclose(a["w"][v].detach().numpy(),
                                       b["w"].detach().numpy(), atol=1e-6)


@pytest.mark.parametrize("iters,every", [(9, 4), (9, 8)])
def test_eval_cadence_matches_fit_atlas(setup, iters, every):
    """Both fits fire evals at the same iterations, an eval on the final
    iteration included, and the multi-fit once per video."""
    _, cfg_t, _, d_t, _, hosts, stacked, _ = setup
    cfg = dataclasses.replace(_tiny_fit_cfg(cfg_t), iters_num=iters,
                              evaluate_every=every)
    specs = teng.build_specs(cfg)
    single = []
    teng.fit_atlas(atlas_params_from_jax(_subset(hosts[0], False)), specs,
                   d_t[0], cfg, torch.Generator().manual_seed(1),
                   eval_callback=lambda i, p, o: single.append(i))
    multi = []
    tmulti.fit_atlas_multi(atlas_params_from_jax(_subset(stacked, False)), specs,
                           tmulti.stack_video_data(d_t), cfg,
                           torch.Generator().manual_seed(1),
                           eval_callback=lambda i, v, p, o: multi.append((i, v)))
    assert single and multi == [(i, v) for i in single for v in range(V)]
