"""Stage-1 engine: per-video test-time fit of the neural layered atlas
(single atlas, or the dual atlas with a foreground and a background layer).

The JAX package's engine (deflicker_tpu/atlas/engine.py) in PyTorch:

  * sampling happens on the device with `torch.randint` and a seeded
    `torch.Generator`;
  * every coordinate variant a step needs (base, gradient offsets, rigidity
    offsets, global-rigidity offsets, flow matches) is stacked into ONE
    forward per network per step; with the default config each forward runs
    through the fused IMLP chain kernel (csrc/imlp_chain.cu);
  * the flow-match subsets of the reference become multiply-by-mask means;
  * steps run in chunks of `steps_per_call`: the loss terms are averaged on
    the device and read back once per chunk, and the chunk boundaries fall
    on the schedule boundaries (global rigidity until
    `stop_global_rigidity`, alpha bootstrapping until
    `stop_bootstrapping_iteration`) and the eval points, as in the JAX
    package.

The dual fit queries four networks a step (mapping1, mapping2, atlas,
alpha); `DEFLICKER_IMLP_STASH=1` sends each through the stash pair of chain
kernels instead of the remat pair (bit-identical gradients).
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import AtlasConfig
from ..losses import (alpha_bootstrap_loss, alpha_flow_loss, flow_loss,
                      gradient_loss, rgb_loss, rigidity_loss, safe_norm,
                      sparsity_loss)
from ..models.imlp import IMLPSpec, imlp_apply, imlp_apply_fused, imlp_init
from ..ops.coords import normalize_xyt
from .data import VideoData

Params = Dict[str, list]


def select_imlp_apply(use_fused: bool = True, precision: str = "default"
                      ) -> Callable:
    """The IMLP forward of the fit: the fused bf16 chain kernel when
    `use_fused` (AtlasConfig.use_pallas_imlp) and precision == "default";
    the plain fp32 `imlp_apply` otherwise ("highest" = reference numerics).
    DEFLICKER_IMLP_STASH=1 (the JAX package's switch) picks the stash pair
    of chain kernels: the backward reads an activation stash the forward
    wrote instead of recomputing the forward."""
    if use_fused and precision == "default":
        if os.environ.get("DEFLICKER_IMLP_STASH") == "1":
            return partial(imlp_apply_fused, stash_bwd=True)
        return imlp_apply_fused
    return imlp_apply


class AtlasSpecs(NamedTuple):
    """Static IMLP architectures for one fit.  mapping2 / alpha are None on
    the single-atlas path (reference: alpha hardwired to 1,
    src/stage1_neural_atlas.py:177)."""

    mapping1: IMLPSpec
    atlas: IMLPSpec
    mapping2: Optional[IMLPSpec] = None
    alpha: Optional[IMLPSpec] = None

    @property
    def dual(self) -> bool:
        return self.mapping2 is not None


def build_specs(cfg: AtlasConfig, dual: bool = False) -> AtlasSpecs:
    """IMLP architectures as the reference instantiates them
    (src/stage1_neural_atlas.py:112-128, src/stage1_neural_atlas_seg.py:127-161)."""
    mapping1 = IMLPSpec(
        input_dim=3, output_dim=2,
        hidden_dim=cfg.number_of_channels_mapping1,
        use_positional=cfg.use_positional_encoding_mapping1,
        positional_dim=cfg.number_of_positional_encoding_mapping1,
        num_layers=cfg.number_of_layers_mapping1, skip_layers=())
    atlas = IMLPSpec(
        input_dim=2, output_dim=3,
        hidden_dim=cfg.number_of_channels_atlas,
        use_positional=True,
        positional_dim=cfg.positional_encoding_num_atlas,
        num_layers=cfg.number_of_layers_atlas, skip_layers=(4, 7))
    if not dual:
        return AtlasSpecs(mapping1, atlas)
    mapping2 = IMLPSpec(
        input_dim=3, output_dim=2,
        hidden_dim=cfg.number_of_channels_mapping2,
        use_positional=cfg.use_positional_encoding_mapping2,
        positional_dim=cfg.number_of_positional_encoding_mapping2,
        num_layers=cfg.number_of_layers_mapping2, skip_layers=())
    alpha = IMLPSpec(
        input_dim=3, output_dim=1,
        hidden_dim=cfg.number_of_channels_alpha,
        use_positional=True,
        positional_dim=cfg.positional_encoding_num_alpha,
        num_layers=cfg.number_of_layers_alpha, skip_layers=())
    return AtlasSpecs(mapping1, atlas, mapping2, alpha)


def init_models(specs: AtlasSpecs, generator: torch.Generator,
                device="cpu") -> Params:
    """Fresh parameters for every network of the fit (mapping1, atlas, then
    on the dual path mapping2 and alpha, drawn in that order from one CPU
    generator, so the single-atlas draws do not depend on `specs.dual`)."""
    params = {"mapping1": imlp_init(specs.mapping1, generator, device),
              "atlas": imlp_init(specs.atlas, generator, device)}
    if specs.dual:
        params["mapping2"] = imlp_init(specs.mapping2, generator, device)
        params["alpha"] = imlp_init(specs.alpha, generator, device)
    return params


def squash_alpha(raw: torch.Tensor) -> torch.Tensor:
    """tanh output -> (0.001, 0.991): 0.5*(a+1)*0.99 + 0.001, the reference's
    BCE-safe squash (src/stage1_neural_atlas_seg.py:224-228)."""
    return 0.5 * (raw + 1.0) * 0.99 + 0.001


def flat_params(params: Params) -> List[torch.Tensor]:
    """Every leaf tensor in a fixed order (networks by name, then layers)."""
    return [layer[k] for name in sorted(params) for layer in params[name]
            for k in ("w", "b")]


def make_loss_fn(specs: AtlasSpecs, cfg: AtlasConfig, data: VideoData,
                 include_global: bool, include_bootstrap: bool = False
                 ) -> Callable:
    """The per-batch loss over sampled integer pixel coords (j, i, f):
    loss_fn(params, packed, j, i, f) -> (total, aux).  `packed` is the
    (T, H, W, 16) gather pack (VideoData.with_packed); `data` supplies only
    the shapes.  One iteration of the reference loop (single:
    src/stage1_neural_atlas.py:159-231; dual:
    src/stage1_neural_atlas_seg.py:204-315) with all queries of a network
    fused into one forward per network.

    The same function is the V-batched loss of the multi-video fit (the
    counterpart of `jax.vmap` over the JAX package's loss): params with a
    leading video axis on every leaf, `packed` (V, T, H, W, 16) and samples
    (V, B) give `total` and every `aux` term of shape (V,), video v's terms
    reading only video v's params, pack and samples."""
    T = data.num_frames
    L = data.larger_dim
    dual = specs.dual
    apply_mlp = select_imlp_apply(cfg.use_pallas_imlp, cfg.fit_precision)
    d = cfg.derivative_amount
    gd_fg = cfg.global_rigidity_derivative_amount_fg
    gd_bg = cfg.global_rigidity_derivative_amount_bg

    # integer offsets of the coordinate variants a mapping is queried at:
    # 0 base, 1 x+1, 2 y+1 (gradient), 3 y-d, 4 x-d (rigidity), then
    # 5 fwd / 6 bwd flow matches, then 7 y-gd, 8 x-gd (global rigidity)
    offsets: Dict[Tuple[torch.device, int],
                  Tuple[torch.Tensor, torch.Tensor]] = {}

    def mapping_coords(j, i, f, ffwd, fbwd, gd):
        """The 7 (9 with global rigidity) coordinate variants of samples
        (..., B), stacked to (..., K, B, 3) in a handful of ops (the step is
        dispatch-bound)."""
        if (j.device, gd) not in offsets:
            dj = [0, 1, 0, 0, -d] + ([0, -gd] if include_global else [])
            di = [0, 0, 1, -d, 0] + ([-gd, 0] if include_global else [])
            offsets[j.device, gd] = tuple(
                torch.tensor(o, dtype=torch.float32, device=j.device)[:, None]
                for o in (dj, di))
        oj, oi = offsets[j.device, gd]
        jf, i_f, ff = (t.float().unsqueeze(-2) for t in (j, i, f))
        (fx, fy), (bx, by) = ffwd.unbind(-1), fbwd.unbind(-1)
        lead = ff.shape[:-2]
        J = torch.cat([jf + oj[:5], jf + fx.unsqueeze(-2),
                       jf + bx.unsqueeze(-2), jf + oj[5:]], dim=-2)
        I = torch.cat([i_f + oi[:5], i_f + fy.unsqueeze(-2),
                       i_f + by.unsqueeze(-2), i_f + oi[5:]], dim=-2)
        F = torch.cat([ff.expand(*lead, 5, -1), ff + 1.0, ff - 1.0,
                       ff.expand(*lead, oj.shape[0] - 5, -1)], dim=-2)
        return normalize_xyt(J, I, F, L, T)

    def run(layers, spec, coords, out_dim):
        """Network on (..., K, B, in) coordinates -> the K variants' outputs,
        each (..., B, out)."""
        *lead, K, B, n_in = coords.shape
        return apply_mlp(layers, coords.reshape(*lead, K * B, n_in),
                         spec).reshape(*lead, K, B, out_dim).unbind(-3)

    def loss_fn(params: Params, packed: torch.Tensor, j: torch.Tensor,
                i: torch.Tensor, f: torch.Tensor):
        if j.dim() == 2:           # (V, B): gather from each video's pack
            video = torch.arange(j.shape[0], device=j.device)[:, None]
            g = packed[video, f, i, j]
        else:
            g = packed[f, i, j]
        rgb_gt, dx_gt, dy_gt, ffwd, fbwd, masks = g.split([3, 3, 3, 2, 2, 3],
                                                          dim=-1)
        mfwd, mbwd, mask = masks.unbind(-1)

        coords1 = mapping_coords(j, i, f, ffwd, fbwd, gd_fg)
        u1 = run(params["mapping1"], specs.mapping1, coords1, 2)

        # atlas queries at base / x+1 / y+1: fg quadrant uv*0.5+0.5, and on
        # the dual path bg quadrant uv*0.5-0.5, in one forward
        # (src/stage1_neural_atlas.py:181, loss_utils.py:157-160)
        atlas_in = [u * 0.5 + 0.5 for u in u1[:3]]
        if dual:
            coords2 = (coords1 if gd_bg == gd_fg or not include_global else
                       mapping_coords(j, i, f, ffwd, fbwd, gd_bg))
            u2 = run(params["mapping2"], specs.mapping2, coords2, 2)
            atlas_in += [u * 0.5 - 0.5 for u in u2[:3]]
        rgb_all = run(params["atlas"], specs.atlas,
                      torch.stack(atlas_in, dim=-3), 3)
        rgb1, rgb1_x, rgb1_y = ((r + 1.0) * 0.5 for r in rgb_all[:3])

        aux: Dict[str, torch.Tensor] = {}
        if dual:
            rgb2, rgb2_x, rgb2_y = ((r + 1.0) * 0.5 for r in rgb_all[3:])
            # alpha at base / x+1 / y+1 / fwd match / bwd match in one
            # forward: variants 0, 1, 2, 5, 6 of the mapping's coordinates
            acoords = torch.cat([coords1.narrow(-3, 0, 3),
                                 coords1.narrow(-3, 5, 2)], dim=-3)
            a, a_x, a_y, a_fwd, a_bwd = (
                squash_alpha(r) for r in run(params["alpha"], specs.alpha,
                                             acoords, 1))

            rgb_pred = rgb1 * a + rgb2 * (1.0 - a)
            rgb_pred_x = rgb1_x * a_x + rgb2_x * (1.0 - a_x)
            rgb_pred_y = rgb1_y * a_y + rgb2_y * (1.0 - a_y)
        else:
            a = 1.0
            rgb_pred, rgb_pred_x, rgb_pred_y = rgb1, rgb1_x, rgb1_y

        l_rgb = rgb_loss(rgb_pred, rgb_gt)
        aux["rgb"] = l_rgb
        total = cfg.rgb_coeff * l_rgb

        if cfg.use_gradient_loss:
            l_grad = gradient_loss(rgb_pred, rgb_pred_x, rgb_pred_y,
                                   dx_gt, dy_gt)
            aux["gradient"] = l_grad
            total = total + cfg.gradient_loss_coeff * l_grad

        l_rig1 = rigidity_loss(u1[0], u1[3], u1[4], d, L, cfg.uv_mapping_scale)
        aux["rigidity1"] = l_rig1
        total = total + cfg.rigidity_coeff * l_rig1
        if include_global:
            l_grig1 = rigidity_loss(u1[0], u1[7], u1[8], gd_fg, L,
                                    cfg.uv_mapping_scale)
            aux["global_rigidity1"] = l_grig1
            total = total + cfg.global_rigidity_coeff_fg * l_grig1

        l_flow1 = flow_loss(u1[0], u1[5], u1[6], mfwd, mbwd, L,
                            cfg.uv_mapping_scale, alpha=a)
        aux["flow1"] = l_flow1
        total = total + cfg.optical_flow_coeff * l_flow1

        if dual:
            l_rig2 = rigidity_loss(u2[0], u2[3], u2[4], d, L,
                                   cfg.uv_mapping_scale)
            aux["rigidity2"] = l_rig2
            total = total + cfg.rigidity_coeff * l_rig2
            if include_global:
                l_grig2 = rigidity_loss(u2[0], u2[7], u2[8], gd_bg, L,
                                        cfg.uv_mapping_scale)
                aux["global_rigidity2"] = l_grig2
                total = total + cfg.global_rigidity_coeff_bg * l_grig2

            l_flow2 = flow_loss(u2[0], u2[5], u2[6], mfwd, mbwd, L,
                                cfg.uv_mapping_scale, alpha=1.0 - a)
            aux["flow2"] = l_flow2
            total = total + cfg.optical_flow_coeff * l_flow2

            l_sparse = sparsity_loss(rgb1, a)
            aux["sparsity"] = l_sparse
            total = total + cfg.sparsity_coeff * l_sparse

            l_aflow = alpha_flow_loss(a, a_fwd, a_bwd, mfwd, mbwd)
            aux["alpha_flow"] = l_aflow
            total = total + cfg.alpha_flow_factor * l_aflow

            if include_bootstrap:
                l_boot = alpha_bootstrap_loss(a, mask)
                aux["alpha_bootstrap"] = l_boot
                total = total + cfg.alpha_bootstrapping_factor * l_boot

        aux["total"] = total
        return total, aux

    return loss_fn


def _adam(tensors, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(tensors, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_optimizer(params: Params, lr: float) -> torch.optim.Adam:
    return _adam(flat_params(params), lr)


def adam_state_to_host(opt: torch.optim.Adam, params: Params) -> dict:
    """The optimizer state as plain numpy (step, first and second moments in
    flat_params order) — what the port's checkpoints hold."""
    flat = flat_params(params)
    st = [opt.state.get(p, {}) for p in flat]
    if not st or "step" not in st[0]:
        return {"step": 0, "exp_avg": None, "exp_avg_sq": None}
    return {"step": int(st[0]["step"]),
            "exp_avg": [s["exp_avg"].detach().cpu().clone().numpy() for s in st],
            "exp_avg_sq": [s["exp_avg_sq"].detach().cpu().clone().numpy()
                           for s in st]}


def adam_state_from_host(opt: torch.optim.Adam, params: Params,
                         state: dict) -> None:
    if not state or not state.get("step"):
        return
    for p, m, v in zip(flat_params(params), state["exp_avg"],
                       state["exp_avg_sq"]):
        opt.state[p] = {
            "step": torch.tensor(float(state["step"])),
            "exp_avg": torch.as_tensor(m).to(p.device).clone(),
            "exp_avg_sq": torch.as_tensor(v).to(p.device).clone()}


@dataclasses.dataclass
class FitResult:
    params: Params
    opt_state: dict
    iteration: int
    logs: List[Dict[str, float]]


def run_fit_schedule(params: Params, specs: AtlasSpecs, data: VideoData,
                     packed: torch.Tensor, cfg: AtlasConfig,
                     generator: torch.Generator, n_videos: Optional[int],
                     start_iteration: int, opt_state: Optional[dict],
                     on_log: Callable[[int, List[Dict[str, float]]], None],
                     on_eval: Callable[[int, torch.optim.Adam], None],
                     rescue_state: Callable[[torch.optim.Adam], dict],
                     rescue_path: str) -> Tuple[torch.optim.Adam, int]:
    """The fit loop of the single fit (`n_videos` None: params and samples
    carry no video axis) and of the multi-video fit (samples (V, B), one
    loss per video, their sum into one backward), from `start_iteration` to
    `cfg.iters_num - 1` on the device of `packed`.

    Steps run in chunks; a chunk ends at `steps_per_call`, at the next
    schedule boundary (global rigidity until `stop_global_rigidity`, alpha
    bootstrapping until `stop_bootstrapping_iteration`), after the next eval
    point, or at the fit's end, as in the JAX package.  After each chunk
    (its one host sync) `on_log(last_iteration, records)` gets the chunk
    mean of every loss term, one record per video; `on_eval(i, optimizer)`
    fires when `i % evaluate_every == 0 and i > start_iteration`
    (src/stage1_neural_atlas.py:246-251).  A non-finite loss dumps
    `rescue_state(optimizer)` to `rescue_path` and raises.  Params are
    updated in place; returns the optimizer and the iteration reached."""
    device = packed.device
    T, (H, W) = data.num_frames, data.res
    optimizer = make_optimizer(params, cfg.learning_rate)
    adam_state_from_host(optimizer, params, opt_state)
    shape = ((cfg.samples_batch,) if n_videos is None
             else (n_videos, cfg.samples_batch))
    boundaries = sorted({cfg.stop_global_rigidity + 1,
                         cfg.stop_bootstrapping_iteration + 1})
    eval_every = max(1, cfg.evaluate_every)
    loss_fns: Dict[Tuple[bool, bool], Callable] = {}

    i = start_iteration
    while i < cfg.iters_num:
        # the loss graph of this chunk, and where the chunk ends
        flags = (cfg.include_global_rigidity_loss
                 and i <= cfg.stop_global_rigidity,
                 specs.dual and i <= cfg.stop_bootstrapping_iteration)
        nxt = i + max(1, cfg.steps_per_call)
        next_eval = ((i // eval_every) + 1) * eval_every + 1  # run through i%e==0
        for b in boundaries + [next_eval]:
            if i < b < nxt:
                nxt = b
        nxt = min(nxt, cfg.iters_num)
        n_steps = nxt - i

        if flags not in loss_fns:
            loss_fns[flags] = make_loss_fn(specs, cfg, data, *flags)
        loss_fn = loss_fns[flags]
        sums: Optional[Dict[str, torch.Tensor]] = None
        for _ in range(n_steps):
            j = torch.randint(0, W, shape, generator=generator, device=device)
            ii = torch.randint(0, H, shape, generator=generator, device=device)
            f = torch.randint(0, T, shape, generator=generator, device=device)
            total, aux = loss_fn(params, packed, j, ii, f)
            optimizer.zero_grad(set_to_none=True)
            total.sum().backward()
            optimizer.step()
            aux = {k: v.detach() for k, v in aux.items()}
            sums = aux if sums is None else {k: sums[k] + aux[k] for k in sums}
        i = nxt
        # the one host sync of the chunk: per-chunk mean of each loss term
        keys = sorted(sums)
        vals = (torch.stack([sums[k] for k in keys]) / n_steps).cpu().numpy()
        vals = vals.reshape(len(keys), -1)
        recs = [{k: float(vals[n, v]) for n, k in enumerate(keys)}
                for v in range(vals.shape[1])]
        bad = [v for v, rec in enumerate(recs) if not np.isfinite(rec["total"])]
        if bad:
            # dump a rescue checkpoint and fail loudly (the reference would
            # silently produce garbage)
            from ..utils.checkpoint import save_checkpoint

            rescue = save_checkpoint(rescue_path, {**rescue_state(optimizer),
                                                   "iteration": i})
            what = recs[0] if n_videos is None else f"video(s) {bad}"
            raise FloatingPointError(
                f"non-finite loss at iteration {i - 1}: {what} "
                f"(state dumped to {rescue})")
        on_log(i - 1, recs)
        if (i - 1) % eval_every == 0 and i - 1 > start_iteration:
            on_eval(i - 1, optimizer)
    return optimizer, i


def fit_atlas(params: Params, specs: AtlasSpecs, data: VideoData,
              cfg: AtlasConfig, generator: torch.Generator,
              start_iteration: int = 0, opt_state: Optional[dict] = None,
              eval_callback: Optional[Callable[[int, Params, dict], None]] = None,
              log_callback: Optional[Callable[[int, Dict[str, float]], None]] = None,
              rescue_path: str = "deflicker_rescue_checkpoint") -> FitResult:
    """Run the fit from `start_iteration` to `cfg.iters_num - 1` on the
    device of `params` (and of `generator`, which draws the samples).

    Evaluation cadence replicates the reference: `eval_callback(i, ...)`
    fires when `i % evaluate_every == 0 and i > start_iteration`
    (src/stage1_neural_atlas.py:246-251) — with the default config exactly
    once, at iteration 10000.  Params are updated in place.
    """
    device = params["mapping1"][0]["w"].device
    # one-gather sampling: the pack is the only fit tensor on the device
    packed = data.with_packed(device).packed
    logs: List[Dict[str, float]] = []

    def on_log(iteration, recs):
        logs.append({"iteration": iteration, **recs[0]})
        if log_callback is not None:
            log_callback(iteration, recs[0])

    def on_eval(iteration, optimizer):
        if eval_callback is not None:
            eval_callback(iteration, params,
                          adam_state_to_host(optimizer, params))

    optimizer, i = run_fit_schedule(
        params, specs, data, packed, cfg, generator, None, start_iteration,
        opt_state, on_log, on_eval,
        lambda opt: {"params": params,
                     "opt_state": adam_state_to_host(opt, params)},
        rescue_path)
    return FitResult(params, adam_state_to_host(optimizer, params), i, logs)


def pretrain_mapping(params: list, spec: IMLPSpec, generator: torch.Generator,
                     num_frames: int, H: int, W: int,
                     uv_mapping_scale: float, pretrain_iters: int = 100,
                     batch: int = 10000, lr: float = 1e-4) -> list:
    """Identity-init pretraining: drive mapping(x, y, t) ≈ scale * (x, y)
    with the reference's schedule (src/models/stage_1/unwrap_utils.py:176-198):
    `pretrain_iters` sweeps over all frames, `batch` random pixels per
    frame-step, Adam(lr) on ||xy * scale - uv||, plain fp32 forward.
    Params are updated in place and returned."""
    device = params[0]["w"].device
    L = max(H, W)
    opt = _adam([layer[k] for layer in params for k in ("w", "b")], lr)
    for _ in range(pretrain_iters):
        for f in range(num_frames):
            i = torch.randint(0, H, (batch,), generator=generator, device=device)
            j = torch.randint(0, W, (batch,), generator=generator, device=device)
            xyt = normalize_xyt(j, i, torch.full((batch,), f, device=device),
                                L, num_frames)
            uv = imlp_apply(params, xyt, spec)
            loss = torch.mean(safe_norm(xyt[:, :2] * uv_mapping_scale - uv))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return params
