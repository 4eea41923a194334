"""Multi-video atlas fitting: V same-shaped videos fit at once on one device.

The JAX package's `atlas/multifit.py` vmaps its fit step over a video axis
(and shards that axis over a TPU mesh).  Here every fit tensor carries the
leading video axis explicitly:

  * parameters and Adam moments are (V, ...) stacks, one `torch.optim.Adam`
    over them: Adam is elementwise and d(sum_v loss_v)/d(theta_v) =
    d(loss_v)/d(theta_v), so one optimizer over the stacks is V independent
    Adams;
  * the loss is `engine.make_loss_fn`'s function on a (V, T, H, W, 16) pack
    and (V, B) samples, which returns a loss per video; their sum takes one
    backward;
  * every network query of a step is ONE chain-kernel launch for all V
    videos (the V-batched form in csrc/imlp_chain.cu), so a step launches
    as many kernels as a one-video step;
  * samples are drawn as (V, B) from one `torch.Generator`.

The fit loop (chunk boundaries, the stop of global rigidity and of
bootstrapping, the eval cadence, the non-finite rescue) is `fit_atlas`'s:
both run `engine.run_fit_schedule`.  `fit_group` and `save_group` are the
group fit and render that the chunked pipeline and the batch CLI share.
The TPU tile caps and the mesh sharding of the JAX module have no
counterpart: the V axis lives on one card.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import AtlasConfig
from ..losses import safe_norm
from ..models.imlp import imlp_apply, imlp_init
from ..ops.coords import normalize_xyt
from ..utils.convert import atlas_params_from_jax
from ..utils.device import synchronize
from .data import VideoData
from .engine import (AtlasSpecs, FitResult, Params, _adam, adam_state_to_host,
                     run_fit_schedule)
from .render import evaluate_and_save
from .texture import export_atlas_artifacts


def stack_video_data(datas: Sequence[VideoData], device="cpu") -> VideoData:
    """Same-shaped videos as one VideoData with a leading V axis: the host
    arrays stack on the host, the gather packs (the only fit tensors) on
    `device`.  Raises if shapes differ (group with `group_by_shape`)."""
    shapes = {tuple(d.video.shape) for d in datas}
    if len(shapes) != 1:
        raise ValueError(f"cannot stack videos of differing shapes: {shapes}")
    packs = [d.with_packed(device).packed for d in datas]
    host = [np.stack([np.asarray(getattr(d, k)) for d in datas])
            for k in VideoData._fields[:-1]]
    return VideoData(*host, packed=torch.stack(packs))


def group_by_shape(datas: Sequence[VideoData]) -> Dict[tuple, List[int]]:
    """Indices of `datas` grouped by (T, H, W): one multi-video fit per
    group."""
    groups: Dict[tuple, List[int]] = {}
    for idx, d in enumerate(datas):
        groups.setdefault(tuple(d.video.shape[:3]), []).append(idx)
    return groups


def init_models_multi(specs: AtlasSpecs, generator: torch.Generator,
                      n_videos: int, device="cpu") -> Params:
    """Fresh parameters for V videos, each leaf (V, ...): network by network
    in `init_models`' order, V networks drawn one after another from the CPU
    generator."""
    nets = ["mapping1", "atlas"] + (["mapping2", "alpha"] if specs.dual else [])
    return {name: imlp_init(getattr(specs, name), generator, device,
                            n_videos=n_videos) for name in nets}


def pretrain_samples(generator: torch.Generator, n_videos: int, batch: int,
                     H: int, W: int, device):
    """One pretrain step's pixel rows i and columns j, each (V, batch)."""
    i = torch.randint(0, H, (n_videos, batch), generator=generator,
                      device=device)
    j = torch.randint(0, W, (n_videos, batch), generator=generator,
                      device=device)
    return i, j


def pretrain_mapping_multi(params_v: list, spec, generator: torch.Generator,
                           num_frames: int, H: int, W: int,
                           uv_mapping_scale: float, pretrain_iters: int = 100,
                           batch: int = 10000, lr: float = 1e-4) -> list:
    """`engine.pretrain_mapping` for V stacked mappings at once (plain fp32,
    the same schedule and loss per video): each step draws (V, batch)
    samples, the per-video losses sum into one backward, one Adam updates
    the stacks.  Params are updated in place and returned."""
    device = params_v[0]["w"].device
    V = params_v[0]["w"].shape[0]
    L = max(H, W)
    opt = _adam([layer[k] for layer in params_v for k in ("w", "b")], lr)
    for _ in range(pretrain_iters):
        for f in range(num_frames):
            i, j = pretrain_samples(generator, V, batch, H, W, device)
            xyt = normalize_xyt(j, i, torch.full((V, batch), f, device=device),
                                L, num_frames)
            uv = imlp_apply(params_v, xyt, spec)
            loss = torch.mean(safe_norm(xyt[..., :2] * uv_mapping_scale - uv),
                              dim=-1).sum()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return params_v


def unstack_tree(tree, n: int) -> list:
    """A tree whose leaves carry a leading V axis -> V trees (leaves are
    detached views for tensors, views for arrays)."""
    def take(node, v):
        if isinstance(node, dict):
            return {k: take(x, v) for k, x in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(take(x, v) for x in node)
        if isinstance(node, torch.Tensor):
            return node.detach()[v]
        if isinstance(node, np.ndarray):
            return node[v]
        return node
    return [take(tree, v) for v in range(n)]


def opt_state_per_video(state: dict, n: int) -> List[dict]:
    """A stacked Adam state (adam_state_to_host of the stacks) -> one per
    video, in the form the single fit's checkpoints hold."""
    if state.get("exp_avg") is None:
        return [dict(state) for _ in range(n)]
    return [{"step": state["step"],
             "exp_avg": [m[v] for m in state["exp_avg"]],
             "exp_avg_sq": [m[v] for m in state["exp_avg_sq"]]}
            for v in range(n)]


def first_video(data_v: VideoData) -> VideoData:
    """Video 0 of a stacked VideoData, on the host (a shape template)."""
    return VideoData(*(np.asarray(x)[0] for x in data_v[:-1]))


def fit_atlas_multi(params_v: Params, specs: AtlasSpecs, data_v: VideoData,
                    cfg: AtlasConfig, generator: torch.Generator,
                    start_iteration: int = 0, opt_state_v: Optional[dict] = None,
                    eval_callback: Optional[Callable] = None,
                    log_callback: Optional[Callable] = None,
                    checkpoint_callback: Optional[Callable] = None,
                    rescue_path: str = "deflicker_rescue_checkpoint_multi"
                    ) -> List[FitResult]:
    """Fit V videos at once from `start_iteration` to `cfg.iters_num - 1`
    (`fit_atlas`'s loop, `engine.run_fit_schedule`, with a video axis);
    returns one FitResult per video.

    `params_v` carries a leading V axis on every leaf (`init_models_multi`),
    `data_v` is `stack_video_data`'s (its pack on the params' device).
    `eval_callback(iteration, v, params, opt_state)` and
    `log_callback(iteration, v, record)` fire per video at `fit_atlas`'s
    cadence.  `checkpoint_callback(iterations_done, state)` fires with
    state = {"params_v", "opt_state_v", "generator_state"} at each eval
    point and once at the end.  Resume: pass `start_iteration` (the steps
    done), the saved `opt_state_v`, and a generator set to the saved state;
    the continuation then replays the uninterrupted fit exactly.  Params
    are updated in place."""
    device = params_v["mapping1"][0]["w"].device
    V = data_v.video.shape[0]
    logs: List[List[Dict[str, float]]] = [[] for _ in range(V)]

    def state(optimizer):
        return {"params_v": params_v,
                "opt_state_v": adam_state_to_host(optimizer, params_v),
                "generator_state": generator.get_state()}

    def on_log(iteration, recs):
        for v, rec in enumerate(recs):
            logs[v].append({"iteration": iteration, **rec})
            if log_callback is not None:
                log_callback(iteration, v, rec)

    def on_eval(iteration, optimizer):
        if eval_callback is not None:
            opts = opt_state_per_video(
                adam_state_to_host(optimizer, params_v), V)
            for v, p in enumerate(unstack_tree(params_v, V)):
                eval_callback(iteration, v, p, opts[v])
        if checkpoint_callback is not None:
            checkpoint_callback(iteration + 1, state(optimizer))

    optimizer, i = run_fit_schedule(
        params_v, specs, first_video(data_v), data_v.packed.to(device), cfg,
        generator, V, start_iteration, opt_state_v, on_log, on_eval, state,
        rescue_path)
    if checkpoint_callback is not None:
        checkpoint_callback(i, state(optimizer))
    opts = opt_state_per_video(adam_state_to_host(optimizer, params_v), V)
    return [FitResult(p, opts[v], i, logs[v])
            for v, p in enumerate(unstack_tree(params_v, V))]


def fit_group(datas: Sequence[VideoData], specs: AtlasSpecs,
              cfg: AtlasConfig, generators: tuple, device,
              resume: Optional[dict] = None,
              log_callback: Optional[Callable] = None,
              checkpoint_callback: Optional[Callable] = None) -> dict:
    """One V-batched fit of same-shaped videos, as the chunked pipeline and
    the batch CLI run it: stack the videos, init the V networks of each
    kind and pretrain the mappings (or take params, Adam moments and the fit
    generator's state from `resume`, a group checkpoint's dict; the JAX
    package's has no generator state, so the generator keeps its seed),
    then `fit_atlas_multi`.  `generators` is the pipeline's (init, pretrain
    mapping1, fit, pretrain mapping2).  Returns {"results": one FitResult
    per video, "start_iteration", "t_pretrain", "t_fit"}."""
    g_init, g_pre, g_fit, g_pre2 = generators
    data_v = stack_video_data(datas, device)
    T, (H, W) = datas[0].num_frames, datas[0].res
    t1 = time.time()
    if resume is not None:
        params_v = atlas_params_from_jax(resume["params_v"], device)
        opt_state_v = resume["opt_state_v"]
        if resume.get("generator_state") is not None:
            g_fit.set_state(torch.as_tensor(resume["generator_state"]))
        start_iteration = int(resume["iteration"])
    else:
        start_iteration, opt_state_v = 0, None
        params_v = init_models_multi(specs, g_init, len(datas), device)
        for name, g, on in (("mapping1", g_pre, cfg.pretrain_mapping1),
                            ("mapping2", g_pre2,
                             specs.dual and cfg.pretrain_mapping2)):
            if on:
                pretrain_mapping_multi(params_v[name], getattr(specs, name), g,
                                       T, H, W, cfg.uv_mapping_scale,
                                       cfg.pretrain_iter_number)
    synchronize(device)
    t2 = time.time()
    results = fit_atlas_multi(params_v, specs, data_v, cfg, g_fit,
                              start_iteration=start_iteration,
                              opt_state_v=opt_state_v,
                              log_callback=log_callback,
                              checkpoint_callback=checkpoint_callback)
    synchronize(device)
    return {"results": results, "start_iteration": start_iteration,
            "t_pretrain": t2 - t1, "t_fit": time.time() - t2}


def save_group(results: Sequence[FitResult], specs: AtlasSpecs,
               datas: Sequence[VideoData], cfg: AtlasConfig,
               outputs: Sequence[dict]) -> List[float]:
    """The final render of every video of a group fit: `outputs[v]` holds
    the video's `folder`, its `texture` folder (exported on the dual path)
    and any further `evaluate_and_save` keywords.  Returns the PSNRs."""
    psnrs = []
    for res, data, out in zip(results, datas, outputs):
        out = dict(out)
        folder, texture = out.pop("folder"), out.pop("texture")
        _, psnr = evaluate_and_save(res.params, specs, data, cfg, folder,
                                    res.iteration - 1, res.opt_state, **out)
        psnrs.append(psnr)
        if specs.dual:
            # each video (or chunk) owns its atlas: one texture set each
            export_atlas_artifacts(res.params, specs, data, texture)
    return psnrs
