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

With a mesh (parallel/mesh.py) the single fit shards its sample batch, as
the JAX package's `shard_constraint` on the sampled (j, i, f) does: every
rank draws the full batch from the same seeded generator and keeps its
block, so the sharded fit sees exactly the unsharded fit's samples; each
loss term is the local sum over the global count (the masked means over
the global mask counts, which every rank reads from the full batch), the
gradients go through one all-reduce a step, and Adam, the same on every
rank, keeps the ranks' params equal.
"""

from __future__ import annotations

import dataclasses
import os
import time
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
from ..parallel.mesh import (Mesh, all_reduce_sum, block, is_main, replicated,
                             shard_constraint)
from ..utils import trace
from .data import VideoData
from .graphs import CapturedStep, FitGraphs

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
    loss_fn(params, packed, j, i, f, norm=None) -> (total, aux).  `packed`
    is the (T, H, W, 16) gather pack (VideoData.with_packed); `data`
    supplies only the shapes.  One iteration of the reference loop (single:
    src/stage1_neural_atlas.py:159-231; dual:
    src/stage1_neural_atlas_seg.py:204-315) with all queries of a network
    fused into one forward per network.

    The same function is the V-batched loss of the multi-video fit (the
    counterpart of `jax.vmap` over the JAX package's loss): params with a
    leading video axis on every leaf, `packed` (V, T, H, W, 16) and samples
    (V, B) give `total` and every `aux` term of shape (V,), video v's terms
    reading only video v's params, pack and samples.

    `norm` = (n, mask_fwd count, mask_bwd count) of the whole batch turns
    every term into this block's share of the whole batch's loss (a
    sharded fit's rank); None takes the means over the samples given."""
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
                i: torch.Tensor, f: torch.Tensor, norm=None):
        n, *denoms = norm if norm is not None else (None, None, None)
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

        l_rgb = rgb_loss(rgb_pred, rgb_gt, n)
        aux["rgb"] = l_rgb
        total = cfg.rgb_coeff * l_rgb

        if cfg.use_gradient_loss:
            l_grad = gradient_loss(rgb_pred, rgb_pred_x, rgb_pred_y,
                                   dx_gt, dy_gt, n)
            aux["gradient"] = l_grad
            total = total + cfg.gradient_loss_coeff * l_grad

        l_rig1 = rigidity_loss(u1[0], u1[3], u1[4], d, L, cfg.uv_mapping_scale,
                               n=n)
        aux["rigidity1"] = l_rig1
        total = total + cfg.rigidity_coeff * l_rig1
        if include_global:
            l_grig1 = rigidity_loss(u1[0], u1[7], u1[8], gd_fg, L,
                                    cfg.uv_mapping_scale, n=n)
            aux["global_rigidity1"] = l_grig1
            total = total + cfg.global_rigidity_coeff_fg * l_grig1

        l_flow1 = flow_loss(u1[0], u1[5], u1[6], mfwd, mbwd, L,
                            cfg.uv_mapping_scale, alpha=a, denoms=denoms)
        aux["flow1"] = l_flow1
        total = total + cfg.optical_flow_coeff * l_flow1

        if dual:
            l_rig2 = rigidity_loss(u2[0], u2[3], u2[4], d, L,
                                   cfg.uv_mapping_scale, n=n)
            aux["rigidity2"] = l_rig2
            total = total + cfg.rigidity_coeff * l_rig2
            if include_global:
                l_grig2 = rigidity_loss(u2[0], u2[7], u2[8], gd_bg, L,
                                        cfg.uv_mapping_scale, n=n)
                aux["global_rigidity2"] = l_grig2
                total = total + cfg.global_rigidity_coeff_bg * l_grig2

            l_flow2 = flow_loss(u2[0], u2[5], u2[6], mfwd, mbwd, L,
                                cfg.uv_mapping_scale, alpha=1.0 - a,
                                denoms=denoms)
            aux["flow2"] = l_flow2
            total = total + cfg.optical_flow_coeff * l_flow2

            l_sparse = sparsity_loss(rgb1, a, n)
            aux["sparsity"] = l_sparse
            total = total + cfg.sparsity_coeff * l_sparse

            l_aflow = alpha_flow_loss(a, a_fwd, a_bwd, mfwd, mbwd, denoms)
            aux["alpha_flow"] = l_aflow
            total = total + cfg.alpha_flow_factor * l_aflow

            if include_bootstrap:
                l_boot = alpha_bootstrap_loss(a, mask, n)
                aux["alpha_bootstrap"] = l_boot
                total = total + cfg.alpha_bootstrapping_factor * l_boot

        aux["total"] = total
        return total, aux

    return loss_fn


def _adam(tensors, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8).  On the card
    the fused implementation with `capturable=True`: its step count lives
    on the device, so a captured step can replay it, and one multi-tensor
    kernel updates every leaf where the foreach implementation launches a
    dozen a step.  Every fit on the card, captured or not, runs this one
    optimizer, so the captured and the eager fit can be bit-equal.  On the
    CPU the default (`capturable=True` raises for CPU tensors)."""
    tensors = list(tensors)
    card = dict(fused=True, capturable=True) if tensors[0].is_cuda else {}
    return torch.optim.Adam(tensors, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            **card)


def make_optimizer(params: Params, lr: float) -> torch.optim.Adam:
    return _adam(flat_params(params), lr)


def adam_state_to_host(opt: torch.optim.Adam, params: Params) -> dict:
    """The optimizer state as plain numpy (step, first and second moments in
    flat_params order) — what the port's checkpoints hold.  The step count
    may live on the device (the card's capturable Adam)."""
    flat = flat_params(params)
    st = [opt.state.get(p, {}) for p in flat]
    if not st or "step" not in st[0]:
        return {"step": 0, "exp_avg": None, "exp_avg_sq": None}
    return {"step": int(st[0]["step"].item()),
            "exp_avg": [s["exp_avg"].detach().cpu().clone().numpy() for s in st],
            "exp_avg_sq": [s["exp_avg_sq"].detach().cpu().clone().numpy()
                           for s in st]}


def adam_state_from_host(opt: torch.optim.Adam, params: Params,
                         state: Optional[dict]) -> None:
    """Load a host Adam state (`adam_state_to_host`'s form) into `opt`.  A
    state the optimizer already holds is written in place (a captured step
    reads its addresses); an empty `state` zeroes it, which is Adam before
    its first step.  The step count goes where the optimizer keeps it: on
    the param's device for the card's capturable Adam, on the host
    otherwise."""
    flat = flat_params(params)
    if not state or not state.get("step"):
        for p in flat:
            for t in opt.state.get(p, {}).values():
                t.zero_()
        return
    on_device = opt.param_groups[0]["capturable"]
    with torch.no_grad():
        for p, m, v in zip(flat, state["exp_avg"], state["exp_avg_sq"]):
            m, v = torch.as_tensor(m), torch.as_tensor(v)
            s = opt.state.get(p)
            if s:
                s["step"].fill_(float(state["step"]))
                s["exp_avg"].copy_(m)
                s["exp_avg_sq"].copy_(v)
                continue
            opt.state[p] = {
                "step": torch.tensor(float(state["step"]),
                                     device=p.device if on_device else "cpu"),
                "exp_avg": m.to(p.device).clone(),
                "exp_avg_sq": v.to(p.device).clone()}


@dataclasses.dataclass
class FitResult:
    params: Params
    opt_state: dict
    iteration: int
    logs: List[Dict[str, float]]


# AtlasConfig fields that set a fit's schedule and never what one step
# computes: fits that differ only in these replay the same graphs
SCHEDULE_FIELDS = ("results_folder_name", "maximum_number_of_frames", "resx",
                   "resy", "iters_num", "evaluate_every",
                   "stop_bootstrapping_iteration", "pretrain_mapping1",
                   "pretrain_mapping2", "pretrain_iter_number",
                   "load_checkpoint", "checkpoint_path", "stop_global_rigidity",
                   "add_to_experiment_folder_name", "steps_per_call", "seed",
                   "save_diagnostics")


def step_config(cfg: AtlasConfig) -> AtlasConfig:
    """`cfg` with its schedule fields at their defaults: what a captured
    fit step depends on, a key of `FitGraphs`."""
    default = AtlasConfig()
    return dataclasses.replace(cfg, **{k: getattr(default, k)
                                       for k in SCHEDULE_FIELDS})


def make_fit_step(loss_fn: Callable, params: Params,
                  optimizer: torch.optim.Adam, packed: torch.Tensor,
                  generator: torch.Generator, shape: tuple,
                  lo: int = 0, hi: Optional[int] = None,
                  mesh: Optional[Mesh] = None) -> Callable:
    """One fit step over fixed tensors, the counterpart of the JAX
    package's `make_scan_step`: draw (j, i, f) of `shape` from `generator`
    (keep samples, or videos, [lo:hi]), run the loss, its backward and
    Adam, and add every loss term into the chunk sums in place: the dict
    `step.sums` holds "keys", the terms in order, and "vals", their sums
    one row each (made at the first step, zeroed by the caller at each
    chunk's start).  With `mesh` (the sample-sharded fit) the terms are
    this block's shares of the whole batch's loss and the gradients are
    summed over the ranks by one all-reduce of a flat buffer made here,
    outside any capture; under NCCL that step is captured like the rest.
    The step's spans `step/loss`, `step/backward` and `step/adam` run
    where its Python runs: in eager steps and at capture."""
    device = packed.device
    T, H, W = packed.shape[-4:-1]
    flat = flat_params(params)
    sums: Dict[str, object] = {}
    buf = (None if mesh is None
           else torch.empty(sum(p.numel() for p in flat), device=device))

    def step():
        with trace.span("step/loss"):
            j = torch.randint(0, W, shape, generator=generator, device=device)
            ii = torch.randint(0, H, shape, generator=generator, device=device)
            f = torch.randint(0, T, shape, generator=generator, device=device)
            norm = None
            if mesh is not None:
                # the whole batch's size and flow-mask counts (data, so no
                # collective): this block's terms are shares of its loss
                counts = packed[f, ii, j, 13:15].sum(0)
                norm = (shape[0], counts[0], counts[1])
            total, aux = loss_fn(params, packed, j[lo:hi], ii[lo:hi],
                                 f[lo:hi], norm)
            if not sums:
                sums["keys"] = sorted(aux)
                sums["vals"] = torch.zeros((len(aux),) + total.shape,
                                           device=device)
            vals = torch.stack([aux[k].detach() for k in sums["keys"]])
        with trace.span("step/backward"):
            optimizer.zero_grad(set_to_none=True)
            total.sum().backward()
            if mesh is not None:
                all_reduce_sum([p.grad for p in flat], mesh, buf)
        with trace.span("step/adam"):
            optimizer.step()
            sums["vals"].add_(vals)

    step.sums = sums
    return step


def pretrain_samples(generator: torch.Generator, n_videos: Optional[int],
                     batch: int, H: int, W: int, device):
    """One pretrain step's pixel rows i, then columns j, each (batch,), or
    (V, batch) for `n_videos` V."""
    shape = (batch,) if n_videos is None else (n_videos, batch)
    i = torch.randint(0, H, shape, generator=generator, device=device)
    j = torch.randint(0, W, shape, generator=generator, device=device)
    return i, j


def make_pretrain_step(params: list, spec: IMLPSpec,
                       optimizer: torch.optim.Adam,
                       generator: torch.Generator, frame: torch.Tensor,
                       num_frames: int, H: int, W: int,
                       uv_mapping_scale: float, batch: int,
                       n_videos: Optional[int] = None, lo: int = 0,
                       hi: Optional[int] = None) -> Callable:
    """One pretrain step over fixed tensors, a step of the JAX package's
    scanned `pretrain_mapping`: `batch` random pixels (`pretrain_samples`)
    of frame `frame` (a device counter the step advances modulo
    `num_frames`, so the frames come in `tile(arange(T), iters)` order),
    Adam on ||xy * scale - uv||.  `n_videos`: the draws are (V, batch), the
    mappings videos [lo:hi] of them, and the videos' mean losses sum into
    one backward."""
    L = max(H, W)
    device = frame.device

    def step():
        i, j = pretrain_samples(generator, n_videos, batch, H, W, device)
        if n_videos is not None:
            i, j = i[lo:hi], j[lo:hi]
        xyt = normalize_xyt(j, i, frame.expand(i.shape), L, num_frames)
        uv = imlp_apply(params, xyt, spec)
        err = safe_norm(xyt[..., :2] * uv_mapping_scale - uv)
        loss = (torch.mean(err) if n_videos is None
                else torch.mean(err, dim=-1).sum())
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        frame.add_(1).remainder_(num_frames)

    return step


def run_fit_schedule(params: Params, specs: AtlasSpecs, data: VideoData,
                     packed: torch.Tensor, cfg: AtlasConfig,
                     generator: torch.Generator, n_videos: Optional[int],
                     start_iteration: int, opt_state: Optional[dict],
                     on_log: Callable[[int, List[Dict[str, float]]], None],
                     on_eval: Callable[[int, dict], None],
                     rescue_state: Callable[[dict], dict],
                     rescue_path: str, mesh: Optional[Mesh] = None,
                     graphs: Optional[FitGraphs] = None
                     ) -> Tuple[dict, int]:
    """The fit loop of the single fit (`n_videos` None: params and samples
    carry no video axis) and of the multi-video fit (samples (V, B), one
    loss per video, their sum into one backward), from `start_iteration` to
    `cfg.iters_num - 1` on the device of `packed`.

    Steps run in chunks; a chunk ends at `steps_per_call`, at the next
    schedule boundary (global rigidity until `stop_global_rigidity`, alpha
    bootstrapping until `stop_bootstrapping_iteration`), after the next eval
    point, or at the fit's end, as in the JAX package.  Each loss phase
    (the chunk's schedule flags) has one step function (`make_fit_step`);
    on the card it is captured as a CUDA graph and a chunk replays it once
    a step (atlas/graphs.py), else its steps run eagerly.  After each
    chunk (its one host sync) `on_log(last_iteration, records)` gets the
    chunk mean of every loss term, one record per video; `on_eval(i,
    adam_state)` fires with the host Adam state when
    `i % evaluate_every == 0 and i > start_iteration`
    (src/stage1_neural_atlas.py:246-251).  A non-finite loss dumps
    `rescue_state(adam_state)` to `rescue_path` and raises.  Params (and
    the generator) are updated in place by the chunk's end; returns the
    host Adam state and the iteration reached.  `graphs`: a `FitGraphs`
    (a kept one replays the graphs of an earlier fit of this shape; one
    with `eager=True` captures nothing); None, this fit's own.

    Its spans (`utils/trace.py`): `fit/start` (the state and the Adam
    state loaded), one `fit/chunk` a chunk around `fit/replay` (the steps
    enqueued), `fit/sync` (the chunk sums back on the host), `fit/check`,
    `fit/store`, `fit/log` and `fit/eval`, and `fit/end` (the host Adam
    state); the counter `fit.start_s`, the host seconds of `fit/start`
    with spans on or off.

    With `mesh`, every rank draws the samples of the whole fit and keeps
    its block of them.  The single fit shards its sample batch: rank 0's
    params are broadcast once, each step's gradients are summed over the
    ranks by one all-reduce of all of them, and each chunk's loss sums by
    one more, so every rank logs, evaluates and raises alike (only rank 0
    writes the rescue file); its steps are captured under NCCL and run
    eagerly under gloo.  The multi-video fit
    shards the video axis: `n_videos` counts the videos of all ranks,
    `params` and `packed` hold this rank's block of them, and no
    collective runs in a step (each chunk's records are gathered at its
    host sync, so every rank logs and raises for every video).
    `rescue_state` runs on every rank."""
    device = packed.device
    sample_sharded = mesh is not None and n_videos is None
    if sample_sharded:
        replicated(flat_params(params), mesh)
    graphs = graphs or FitGraphs()
    capture = graphs.capturing(device, "fit",
                               mesh.backend if sample_sharded else None)
    shape = ((cfg.samples_batch,) if n_videos is None
             else (n_videos, cfg.samples_batch))
    lo, hi = block(shape[0], mesh)    # this rank's samples, or videos
    key = ("fit", str(device), capture, tuple(packed.shape), shape, lo, hi,
           specs, os.environ.get("DEFLICKER_IMLP_STASH") == "1",
           step_config(cfg))
    t0 = time.perf_counter()
    with trace.span("fit/start"):
        st = graphs.state(key, params, generator,
                          lambda p: make_optimizer(p, cfg.learning_rate),
                          packed=packed)
        adam_state_from_host(st.optimizer, st.params, opt_state)
    trace.add_seconds("fit.start_s", time.perf_counter() - t0)
    boundaries = sorted({cfg.stop_global_rigidity + 1,
                         cfg.stop_bootstrapping_iteration + 1})
    eval_every = max(1, cfg.evaluate_every)

    def host_state() -> dict:
        st.store(params, generator)
        return adam_state_to_host(st.optimizer, st.params)

    i = start_iteration
    while i < cfg.iters_num:
        with trace.span("fit/chunk"):
            # the loss graph of this chunk, and where the chunk ends
            flags = (cfg.include_global_rigidity_loss
                     and i <= cfg.stop_global_rigidity,
                     specs.dual and i <= cfg.stop_bootstrapping_iteration)
            nxt = i + max(1, cfg.steps_per_call)
            # run through i % eval_every == 0
            next_eval = ((i // eval_every) + 1) * eval_every + 1
            for b in boundaries + [next_eval]:
                if i < b < nxt:
                    nxt = b
            nxt = min(nxt, cfg.iters_num)
            n_steps = nxt - i

            if flags not in st.steps:
                fn = make_fit_step(make_loss_fn(specs, cfg, data, *flags),
                                   st.params, st.optimizer,
                                   st.tensors["packed"], st.generator, shape,
                                   lo, hi, mesh if sample_sharded else None)
                st.steps[flags] = CapturedStep(fn)
            runner = st.steps[flags]
            sums = runner.step.sums
            with trace.span("fit/replay"):
                if sums:
                    sums["vals"].zero_()
                runner.run(graphs if capture else None, st, n_steps)
            i = nxt
            # the one host sync of the chunk: per-chunk mean of each loss term
            with trace.span("fit/sync"):
                keys, vals = sums["keys"], sums["vals"]
                if sample_sharded:
                    all_reduce_sum(vals, mesh)
                elif mesh is not None:
                    # every rank gets every video's record (and raises alike)
                    vals = shard_constraint(vals.reshape(len(keys), -1),
                                            mesh, 1, n_videos)
                vals = (vals / n_steps).cpu().numpy()
            with trace.span("fit/check"):
                vals = vals.reshape(len(keys), -1)
                recs = [{k: float(vals[n, v]) for n, k in enumerate(keys)}
                        for v in range(vals.shape[1])]
                bad = [v for v, rec in enumerate(recs)
                       if not np.isfinite(rec["total"])]
                if bad:
                    # dump a rescue checkpoint and fail loudly (the reference
                    # would silently produce garbage)
                    from ..utils.checkpoint import save_checkpoint

                    state, rescue = rescue_state(host_state()), rescue_path
                    if is_main(mesh):
                        rescue = save_checkpoint(rescue_path,
                                                 {**state, "iteration": i})
                    what = recs[0] if n_videos is None else f"video(s) {bad}"
                    raise FloatingPointError(
                        f"non-finite loss at iteration {i - 1}: {what} "
                        f"(state dumped to {rescue})")
            with trace.span("fit/store"):
                st.store(params, generator)
            with trace.span("fit/log"):
                on_log(i - 1, recs)
            if (i - 1) % eval_every == 0 and i - 1 > start_iteration:
                with trace.span("fit/eval"):
                    on_eval(i - 1, host_state())
    with trace.span("fit/end"):
        return host_state(), i


def fit_atlas(params: Params, specs: AtlasSpecs, data: VideoData,
              cfg: AtlasConfig, generator: torch.Generator,
              start_iteration: int = 0, opt_state: Optional[dict] = None,
              eval_callback: Optional[Callable[[int, Params, dict], None]] = None,
              log_callback: Optional[Callable[[int, Dict[str, float]], None]] = None,
              rescue_path: str = "deflicker_rescue_checkpoint",
              mesh: Optional[Mesh] = None,
              graphs: Optional[FitGraphs] = None) -> FitResult:
    """Run the fit from `start_iteration` to `cfg.iters_num - 1` on the
    device of `params` (and of `generator`, which draws the samples).

    Evaluation cadence replicates the reference: `eval_callback(i, ...)`
    fires when `i % evaluate_every == 0 and i > start_iteration`
    (src/stage1_neural_atlas.py:246-251) — with the default config exactly
    once, at iteration 10000.  Params are updated in place.  With `mesh`
    the sample batch is sharded over its ranks (`run_fit_schedule`), every
    rank calls `fit_atlas` alike and ends with the same params.  On the
    card each loss phase's step is one CUDA graph (`graphs`: see
    `run_fit_schedule`).
    """
    device = params["mapping1"][0]["w"].device
    # one-gather sampling: the pack is the only fit tensor on the device
    packed = data.with_packed(device).packed
    logs: List[Dict[str, float]] = []

    def on_log(iteration, recs):
        logs.append({"iteration": iteration, **recs[0]})
        if log_callback is not None:
            log_callback(iteration, recs[0])

    def on_eval(iteration, opt_host):
        if eval_callback is not None:
            eval_callback(iteration, params, opt_host)

    opt_host, i = run_fit_schedule(
        params, specs, data, packed, cfg, generator, None, start_iteration,
        opt_state, on_log, on_eval,
        lambda opt_host: {"params": params, "opt_state": opt_host},
        rescue_path, mesh, graphs)
    return FitResult(params, opt_host, i, logs)


def pretrain_mapping(params: list, spec: IMLPSpec, generator: torch.Generator,
                     num_frames: int, H: int, W: int,
                     uv_mapping_scale: float, pretrain_iters: int = 100,
                     batch: int = 10000, lr: float = 1e-4,
                     graphs: Optional[FitGraphs] = None,
                     n_videos: Optional[int] = None, lo: int = 0,
                     hi: Optional[int] = None) -> list:
    """Identity-init pretraining: drive mapping(x, y, t) ≈ scale * (x, y)
    with the reference's schedule (src/models/stage_1/unwrap_utils.py:176-198):
    `pretrain_iters` sweeps over all frames, `batch` random pixels per
    frame-step, Adam(lr) on ||xy * scale - uv||, plain fp32 forward.  The
    steps are `make_pretrain_step`'s: on the card one CUDA graph replayed
    `pretrain_iters x num_frames` times (`graphs` as in
    `run_fit_schedule`), eager steps elsewhere.  `n_videos`, `lo`, `hi`:
    the stacked mappings of `multifit.pretrain_mapping_multi`.  Params are
    updated in place and returned; the whole pretrain is one span,
    `fit/pretrain`."""
    with trace.span("fit/pretrain"):
        device = params[0]["w"].device
        graphs = graphs or FitGraphs()
        capture = graphs.capturing(device, "pretrain")
        key = ("pretrain", str(device), capture, spec, num_frames, H, W,
               uv_mapping_scale, batch, lr, n_videos, lo, hi)
        st = graphs.state(key, {"mapping": params}, generator,
                          lambda p: _adam(flat_params(p), lr),
                          frame=torch.zeros((), dtype=torch.int64,
                                            device=device))
        adam_state_from_host(st.optimizer, st.params, None)
        if None not in st.steps:
            fn = make_pretrain_step(st.params["mapping"], spec, st.optimizer,
                                    st.generator, st.tensors["frame"],
                                    num_frames, H, W, uv_mapping_scale, batch,
                                    n_videos, lo, hi)
            st.steps[None] = CapturedStep(fn)
        st.steps[None].run(graphs if capture else None, st,
                           pretrain_iters * num_frames)
        st.store({"mapping": params}, generator)
    return params
