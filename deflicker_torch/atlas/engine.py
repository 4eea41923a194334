"""Stage-1 engine: per-video test-time fit of the neural atlas (single atlas).

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
    `stop_global_rigidity`) and the eval points, as in the JAX package.

The dual-atlas branches (mapping2, alpha, sparsity and bootstrap terms) are
a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import AtlasConfig
from ..losses import (flow_loss, gradient_loss, rgb_loss, rigidity_loss,
                      safe_norm)
from ..models.imlp import IMLPSpec, imlp_apply, imlp_apply_fused, imlp_init
from ..ops.coords import normalize_xyt
from .data import VideoData

Params = Dict[str, list]


def select_imlp_apply(use_fused: bool = True, precision: str = "default"
                      ) -> Callable:
    """The IMLP forward of the fit: the fused bf16 chain kernel when
    `use_fused` (AtlasConfig.use_pallas_imlp) and precision == "default";
    the plain fp32 `imlp_apply` otherwise ("highest" = reference numerics)."""
    if use_fused and precision == "default":
        return imlp_apply_fused
    return imlp_apply


class AtlasSpecs(NamedTuple):
    """Static IMLP architectures of a single-atlas fit (the dual atlas's
    mapping2 and alpha networks are a later slice of the port)."""

    mapping1: IMLPSpec
    atlas: IMLPSpec


def build_specs(cfg: AtlasConfig, dual: bool = False) -> AtlasSpecs:
    """IMLP architectures as the reference instantiates them
    (src/stage1_neural_atlas.py:112-128)."""
    if dual:
        raise NotImplementedError("the dual-atlas fit is a later slice of the "
                                  "port (see ROADMAP.md)")
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
    return AtlasSpecs(mapping1, atlas)


def init_models(specs: AtlasSpecs, generator: torch.Generator,
                device="cpu") -> Params:
    """Fresh parameters for every network of the fit (mapping1, then atlas,
    drawn from one CPU generator)."""
    return {"mapping1": imlp_init(specs.mapping1, generator, device),
            "atlas": imlp_init(specs.atlas, generator, device)}


def flat_params(params: Params) -> List[torch.Tensor]:
    """Every leaf tensor in a fixed order (networks by name, then layers)."""
    return [layer[k] for name in sorted(params) for layer in params[name]
            for k in ("w", "b")]


def make_loss_fn(specs: AtlasSpecs, cfg: AtlasConfig, data: VideoData,
                 include_global: bool) -> Callable:
    """The per-batch loss over sampled integer pixel coords (j, i, f):
    loss_fn(params, packed, j, i, f) -> (total, aux).  `packed` is the
    (T, H, W, 16) gather pack (VideoData.with_packed); `data` supplies only
    the shapes.  One iteration of the reference loop
    (src/stage1_neural_atlas.py:159-231) with all mapping queries fused into
    one forward per network."""
    T, (H, W) = data.num_frames, data.res
    L = data.larger_dim
    apply_mlp = select_imlp_apply(cfg.use_pallas_imlp, cfg.fit_precision)
    d = cfg.derivative_amount
    gd = cfg.global_rigidity_derivative_amount_fg

    # integer offsets of the coordinate variants the mapping is queried at:
    # 0 base, 1 x+1, 2 y+1 (gradient), 3 y-d, 4 x-d (rigidity), then
    # 5 fwd / 6 bwd flow matches, then 7 y-gd, 8 x-gd (global rigidity)
    dj = [0, 1, 0, 0, -d] + ([0, -gd] if include_global else [])
    di = [0, 0, 1, -d, 0] + ([-gd, 0] if include_global else [])
    offsets: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def mapping_coords(j, i, f, ffwd, fbwd):
        """The 7 (9 with global rigidity) coordinate variants, stacked to
        (K, B, 3) in a handful of ops (the step is dispatch-bound)."""
        if j.device not in offsets:
            offsets[j.device] = tuple(
                torch.tensor(o, dtype=torch.float32, device=j.device)[:, None]
                for o in (dj, di))
        oj, oi = offsets[j.device]
        jf, i_f, ff = j.float(), i.float(), f.float()
        J = torch.cat([jf + oj[:5], (jf + ffwd[:, 0])[None],
                       (jf + fbwd[:, 0])[None], jf + oj[5:]])
        I = torch.cat([i_f + oi[:5], (i_f + ffwd[:, 1])[None],
                       (i_f + fbwd[:, 1])[None], i_f + oi[5:]])
        F = torch.cat([ff.expand(5, -1), (ff + 1.0)[None], (ff - 1.0)[None],
                       ff.expand(len(dj) - 5, -1)])
        return normalize_xyt(J, I, F, L, T)

    def loss_fn(params: Params, packed: torch.Tensor, j: torch.Tensor,
                i: torch.Tensor, f: torch.Tensor):
        B = j.shape[0]
        g = packed[f, i, j]
        rgb_gt, dx_gt, dy_gt = g[:, 0:3], g[:, 3:6], g[:, 6:9]
        ffwd, fbwd = g[:, 9:11], g[:, 11:13]
        mfwd, mbwd = g[:, 13], g[:, 14]

        coords = mapping_coords(j, i, f, ffwd, fbwd)
        K = coords.shape[0]
        uv1 = apply_mlp(params["mapping1"], coords.reshape(K * B, 3),
                        specs.mapping1).reshape(K, B, 2)

        # atlas queries at base / x+1 / y+1 in the fg quadrant uv*0.5+0.5
        # (src/stage1_neural_atlas.py:181, loss_utils.py:157-160)
        atlas_in = torch.cat([uv1[0] * 0.5 + 0.5, uv1[1] * 0.5 + 0.5,
                              uv1[2] * 0.5 + 0.5], dim=0)
        rgb_all = (apply_mlp(params["atlas"], atlas_in, specs.atlas)
                   + 1.0) * 0.5
        rgb_all = rgb_all.reshape(3, B, 3)
        rgb_pred, rgb_pred_x, rgb_pred_y = rgb_all[0], rgb_all[1], rgb_all[2]

        aux: Dict[str, torch.Tensor] = {}
        l_rgb = rgb_loss(rgb_pred, rgb_gt)
        aux["rgb"] = l_rgb
        total = cfg.rgb_coeff * l_rgb

        if cfg.use_gradient_loss:
            l_grad = gradient_loss(rgb_pred, rgb_pred_x, rgb_pred_y,
                                   dx_gt, dy_gt)
            aux["gradient"] = l_grad
            total = total + cfg.gradient_loss_coeff * l_grad

        l_rig1 = rigidity_loss(uv1[0], uv1[3], uv1[4], d, L,
                               cfg.uv_mapping_scale)
        aux["rigidity1"] = l_rig1
        total = total + cfg.rigidity_coeff * l_rig1
        if include_global:
            l_grig1 = rigidity_loss(uv1[0], uv1[7], uv1[8], gd, L,
                                    cfg.uv_mapping_scale)
            aux["global_rigidity1"] = l_grig1
            total = total + cfg.global_rigidity_coeff_fg * l_grig1

        l_flow1 = flow_loss(uv1[0], uv1[5], uv1[6], mfwd, mbwd, L,
                            cfg.uv_mapping_scale, alpha=1.0)
        aux["flow1"] = l_flow1
        total = total + cfg.optical_flow_coeff * l_flow1

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
    T, (H, W) = data.num_frames, data.res
    # one-gather sampling: the pack is the only fit tensor on the device
    packed = data.with_packed(device).packed
    optimizer = make_optimizer(params, cfg.learning_rate)
    adam_state_from_host(optimizer, params, opt_state)
    batch = cfg.samples_batch

    def include_global(i: int) -> bool:
        return cfg.include_global_rigidity_loss and i <= cfg.stop_global_rigidity

    boundaries = sorted({cfg.stop_global_rigidity + 1,
                         cfg.stop_bootstrapping_iteration + 1})
    eval_every = max(1, cfg.evaluate_every)
    loss_fns: Dict[bool, Callable] = {}
    logs: List[Dict[str, float]] = []

    i = start_iteration
    while i < cfg.iters_num:
        flag = include_global(i)
        # chunk end: next schedule boundary, next eval point, or fit end
        nxt = i + max(1, cfg.steps_per_call)
        for b in boundaries:
            if i < b < nxt:
                nxt = b
        next_eval = ((i // eval_every) + 1) * eval_every + 1  # run through i%e==0
        if i < next_eval < nxt:
            nxt = next_eval
        nxt = min(nxt, cfg.iters_num)
        n_steps = nxt - i

        if flag not in loss_fns:
            loss_fns[flag] = make_loss_fn(specs, cfg, data, flag)
        loss_fn = loss_fns[flag]
        sums: Optional[Dict[str, torch.Tensor]] = None
        for _ in range(n_steps):
            j = torch.randint(0, W, (batch,), generator=generator, device=device)
            ii = torch.randint(0, H, (batch,), generator=generator, device=device)
            f = torch.randint(0, T, (batch,), generator=generator, device=device)
            total, aux = loss_fn(params, packed, j, ii, f)
            optimizer.zero_grad(set_to_none=True)
            total.backward()
            optimizer.step()
            aux = {k: v.detach() for k, v in aux.items()}
            sums = aux if sums is None else {k: sums[k] + aux[k] for k in sums}
        i = nxt
        # the one host sync of the chunk: per-chunk mean of each loss term
        keys = sorted(sums)
        vals = (torch.stack([sums[k] for k in keys]) / n_steps).cpu().numpy()
        rec = {k: float(v) for k, v in zip(keys, vals)}
        if not np.isfinite(rec["total"]):
            # dump a rescue checkpoint and fail loudly (the reference would
            # silently produce garbage)
            from ..utils.checkpoint import save_checkpoint

            rescue = save_checkpoint(rescue_path, {
                "params": params,
                "opt_state": adam_state_to_host(optimizer, params),
                "iteration": i})
            raise FloatingPointError(
                f"non-finite loss at iteration {i - 1}: {rec} "
                f"(state dumped to {rescue})")
        logs.append({"iteration": i - 1, **rec})
        if log_callback is not None:
            log_callback(i - 1, rec)

        last = i - 1
        if (eval_callback is not None and last % eval_every == 0
                and last > start_iteration):
            eval_callback(last, params, adam_state_to_host(optimizer, params))

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
