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
  * samples are drawn as (V, B) from one `torch.Generator`;
  * on the card a step is one CUDA graph replay, as in the single fit
    (atlas/graphs.py), the counterpart of the JAX module's scanned
    `_run_chunk_multi`.

The fit loop (chunk boundaries, the stop of global rigidity and of
bootstrapping, the eval cadence, the non-finite rescue) is `fit_atlas`'s:
both run `engine.run_fit_schedule`.  `fit_group` and `save_group` are the
group fit and render that the chunked pipeline and the batch CLI share.

With a mesh the V axis splits over the ranks, as the JAX module shards it:
every rank draws what the whole group's fit draws (inits, pretrain and fit
samples) and keeps its block of videos, so each video fits exactly as in
the unsplit group, and no collective runs in a step.  The fitted params
and Adam moments are gathered at the eval points and the end, so every
rank holds every video's result.  A group whose V does not divide by the
ranks fits unsplit on every rank (the JAX rule).  The TPU tile caps of the
JAX module have no counterpart.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import AtlasConfig
from ..models.imlp import imlp_init
from ..parallel.mesh import Mesh, block, is_main, shard_constraint
from ..utils.convert import atlas_params_from_jax
from ..utils.device import synchronize
from .data import VideoData
from .engine import (AtlasSpecs, FitResult, Params, pretrain_mapping,
                     pretrain_samples, run_fit_schedule)
from .graphs import FitGraphs
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


def pretrain_mapping_multi(params_v: list, spec, generator: torch.Generator,
                           num_frames: int, H: int, W: int,
                           uv_mapping_scale: float, pretrain_iters: int = 100,
                           batch: int = 10000, lr: float = 1e-4,
                           mesh: Optional[Mesh] = None,
                           graphs: Optional[FitGraphs] = None) -> list:
    """`engine.pretrain_mapping` for V stacked mappings at once (plain fp32,
    the same schedule and loss per video): each step draws (V, batch)
    samples (`pretrain_samples`), the per-video losses sum into one
    backward, one Adam updates the stacks; on the card one CUDA graph a
    step (`graphs` as in `engine.pretrain_mapping`).  With `mesh` the
    stacks hold this rank's block of the group's videos: each step draws
    the whole group's samples and keeps the block's.  Params are updated
    in place and returned."""
    V = params_v[0]["w"].shape[0]
    n_all = V * (mesh.size if mesh is not None else 1)
    lo, hi = block(n_all, mesh)
    return pretrain_mapping(params_v, spec, generator, num_frames, H, W,
                            uv_mapping_scale, pretrain_iters, batch, lr,
                            graphs, n_videos=n_all, lo=lo, hi=hi)


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
                    rescue_path: str = "deflicker_rescue_checkpoint_multi",
                    mesh: Optional[Mesh] = None,
                    graphs: Optional[FitGraphs] = None) -> List[FitResult]:
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
    are updated in place.  `graphs`: see `engine.run_fit_schedule`.

    With `mesh`, `params_v`, `data_v` and `opt_state_v` hold this rank's
    block of a group of V = blocks x ranks videos (an even split); the
    callbacks, the checkpoint state and the results cover all V on every
    rank (gathered at the eval points and the end)."""
    device = params_v["mapping1"][0]["w"].device
    V = data_v.video.shape[0] * (mesh.size if mesh is not None else 1)
    logs: List[List[Dict[str, float]]] = [[] for _ in range(V)]

    def gather(x: torch.Tensor) -> torch.Tensor:
        return shard_constraint(x.detach(), mesh, 0, V)

    def state(opt):
        """Params, host Adam state `opt` (all V videos) and generator
        state."""
        params = params_v
        if mesh is not None:
            params = {name: [{k: gather(t) for k, t in layer.items()}
                             for layer in layers]
                      for name, layers in params_v.items()}
            if opt["exp_avg"] is not None:
                for key in ("exp_avg", "exp_avg_sq"):
                    opt[key] = [gather(torch.from_numpy(m).to(device)).cpu()
                                .numpy() for m in opt[key]]
        return {"params_v": params, "opt_state_v": opt,
                "generator_state": generator.get_state()}

    def on_log(iteration, recs):
        for v, rec in enumerate(recs):
            logs[v].append({"iteration": iteration, **rec})
            if log_callback is not None:
                log_callback(iteration, v, rec)

    def on_eval(iteration, opt):
        if eval_callback is None and checkpoint_callback is None:
            return
        st = state(opt)
        if eval_callback is not None:
            opts = opt_state_per_video(st["opt_state_v"], V)
            for v, p in enumerate(unstack_tree(st["params_v"], V)):
                eval_callback(iteration, v, p, opts[v])
        if checkpoint_callback is not None:
            checkpoint_callback(iteration + 1, st)

    opt, i = run_fit_schedule(
        params_v, specs, first_video(data_v), data_v.packed.to(device), cfg,
        generator, V, start_iteration, opt_state_v, on_log, on_eval, state,
        rescue_path, mesh, graphs)
    st = state(opt)
    if checkpoint_callback is not None:
        checkpoint_callback(i, st)
    opts = opt_state_per_video(st["opt_state_v"], V)
    return [FitResult(p, opts[v], i, logs[v])
            for v, p in enumerate(unstack_tree(st["params_v"], V))]


def fit_group(datas: Sequence[VideoData], specs: AtlasSpecs,
              cfg: AtlasConfig, generators: tuple, device,
              resume: Optional[dict] = None,
              log_callback: Optional[Callable] = None,
              checkpoint_callback: Optional[Callable] = None,
              mesh: Optional[Mesh] = None,
              graphs: Optional[FitGraphs] = None) -> dict:
    """One V-batched fit of same-shaped videos, as the chunked pipeline and
    the batch CLI run it: stack the videos, init the V networks of each
    kind and pretrain the mappings (or take params, Adam moments and the fit
    generator's state from `resume`, a group checkpoint's dict; the JAX
    package's has no generator state, so the generator keeps its seed),
    then `fit_atlas_multi`.  `generators` is the pipeline's (init, pretrain
    mapping1, fit, pretrain mapping2).  Returns {"results": one FitResult
    per video, "start_iteration", "t_pretrain", "t_fit"}.

    With `mesh` the videos split over its ranks when their count divides
    by the ranks (else every rank fits them all); every rank returns every
    video's result and calls the callbacks alike.  `graphs`: a kept
    `FitGraphs` whose graphs the pretrains and the fit replay."""
    g_init, g_pre, g_fit, g_pre2 = generators
    V = len(datas)
    if mesh is not None and (mesh.size <= 1 or V % mesh.size):
        mesh = None
    lo, hi = block(V, mesh)
    data_v = stack_video_data(datas[lo:hi], device)
    T, (H, W) = datas[0].num_frames, datas[0].res
    t1 = time.time()
    if resume is not None:
        params_v = atlas_params_from_jax(_rows(resume["params_v"], lo, hi),
                                         device)
        opt_state_v = _rows(resume["opt_state_v"], lo, hi)
        if resume.get("generator_state") is not None:
            g_fit.set_state(torch.as_tensor(resume["generator_state"]))
        start_iteration = int(resume["iteration"])
    else:
        start_iteration, opt_state_v = 0, None
        params_v = _rows(init_models_multi(specs, g_init, V, device), lo, hi)
        for name, g, on in (("mapping1", g_pre, cfg.pretrain_mapping1),
                            ("mapping2", g_pre2,
                             specs.dual and cfg.pretrain_mapping2)):
            if on:
                pretrain_mapping_multi(params_v[name], getattr(specs, name), g,
                                       T, H, W, cfg.uv_mapping_scale,
                                       cfg.pretrain_iter_number, mesh=mesh,
                                       graphs=graphs)
    synchronize(device)
    t2 = time.time()
    results = fit_atlas_multi(params_v, specs, data_v, cfg, g_fit,
                              start_iteration=start_iteration,
                              opt_state_v=opt_state_v,
                              log_callback=log_callback,
                              checkpoint_callback=checkpoint_callback,
                              mesh=mesh, graphs=graphs)
    synchronize(device)
    return {"results": results, "start_iteration": start_iteration,
            "t_pretrain": t2 - t1, "t_fit": time.time() - t2}


def _rows(tree, lo: int, hi: int):
    """Videos [lo, hi) of a tree whose tensor and array leaves carry a
    leading video axis (tensors come back as fresh leaves that keep
    `requires_grad`); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _rows(x, lo, hi) for k, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rows(x, lo, hi) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach()[lo:hi].clone().requires_grad_(tree.requires_grad)
    if isinstance(tree, np.ndarray) and tree.ndim:
        return tree[lo:hi]
    return tree


def save_group(results: Sequence[FitResult], specs: AtlasSpecs,
               datas: Sequence[VideoData], cfg: AtlasConfig,
               outputs: Sequence[dict], mesh: Optional[Mesh] = None
               ) -> List[float]:
    """The final render of every video of a group fit: `outputs[v]` holds
    the video's `folder`, its `texture` folder (exported on the dual path)
    and any further `evaluate_and_save` keywords.  Returns the PSNRs.
    With `mesh` every rank calls it with every video's result: the frames
    of each render split over the ranks, rank 0 writes."""
    psnrs = []
    for res, data, out in zip(results, datas, outputs):
        out = dict(out)
        folder, texture = out.pop("folder"), out.pop("texture")
        _, psnr = evaluate_and_save(res.params, specs, data, cfg, folder,
                                    res.iteration - 1, res.opt_state,
                                    mesh=mesh, **out)
        psnrs.append(psnr)
        if specs.dual and is_main(mesh):
            # each video (or chunk) owns its atlas: one texture set each
            export_atlas_artifacts(res.params, specs, data, texture)
    return psnrs
