"""Rank bodies of the multi-rank CPU tests (tests/test_torch_parallel.py,
tests/test_torch_parallel_graph.py).

`deflicker_torch.parallel.launch` starts each body in spawned processes,
one gloo rank each, so the bodies live at module level in a module that
imports only torch and the port.  Each takes the rank's `Mesh` first and
returns numpy arrays and plain values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deflicker_torch.atlas import engine as teng
from deflicker_torch.atlas.graphs import FitGraphs
from deflicker_torch.parallel.mesh import all_reduce_sum, block
from deflicker_torch.utils.convert import atlas_params_from_jax

torch.set_num_threads(1)


def _flat_grad(params) -> np.ndarray:
    return torch.cat([p.grad.reshape(-1)
                      for p in teng.flat_params(params)]).numpy().copy()


def fit(mesh, host, cfg, data, jif, cases, steps):
    """Per loss case (dual, include_global, include_bootstrap, precision):
    the unsharded loss and flat gradient on samples `jif`, and the sharded
    ones (this rank's block, the global counts, one all-reduce of the
    gradients and one of the terms); then a `steps`-step `fit_atlas` of
    the single atlas, unsharded and sharded, from the same generator."""
    j, i, f = (torch.as_tensor(x) for x in jif)
    packed = data.with_packed().packed
    out = {}
    for case in cases:
        dual, include_global, include_boot, precision = case
        c = dataclasses.replace(cfg, fit_precision=precision)
        specs = teng.build_specs(c, dual=dual)
        loss_fn = teng.make_loss_fn(specs, c, data, include_global,
                                    include_boot)
        p = atlas_params_from_jax(host[dual])
        total, aux = loss_fn(p, packed, j, i, f)
        total.backward()
        ref = (total.item(), {k: v.item() for k, v in aux.items()},
               _flat_grad(p))

        p = atlas_params_from_jax(host[dual])
        lo, hi = block(j.numel(), mesh)
        counts = packed[f, i, j, 13:15].sum(0)
        total, aux = loss_fn(p, packed, j[lo:hi], i[lo:hi], f[lo:hi],
                             (j.numel(), counts[0], counts[1]))
        total.backward()
        all_reduce_sum([q.grad for q in teng.flat_params(p)], mesh)
        keys = sorted(aux)
        terms = all_reduce_sum(torch.stack([aux[k].detach() for k in keys]),
                               mesh)
        out[case] = {"ref": ref, "total": terms[keys.index("total")].item(),
                     "aux": dict(zip(keys, terms.tolist())),
                     "grad": _flat_grad(p), "rows": hi - lo}

    c = dataclasses.replace(cfg, iters_num=steps, steps_per_call=1,
                            evaluate_every=steps + 1,
                            stop_global_rigidity=steps // 2)
    specs = teng.build_specs(c)
    logs = {}
    for name, m in (("single", None), ("sharded", mesh)):
        p = atlas_params_from_jax(host[False])
        res = teng.fit_atlas(p, specs, data, c,
                             torch.Generator().manual_seed(5), mesh=m)
        logs[name] = ([r["total"] for r in res.logs], _params_np(p))
    out["fit"] = logs
    return out


def _params_np(params) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1)
                      for p in teng.flat_params(params)]).numpy().copy()


def paths(mesh, host, cfg, data, frames, pairs, datas_v):
    """The split helpers, then each sharded path on this rank: the render
    (`render_frames`, a few frames a call), the RAFT pair batch
    (`RAFTFlow.compute_batch`, more pairs than ranks and an odd count), the
    U-Net frame batch (`FilterEngine._filter_all`) and a V = 2 group fit
    (`multifit.fit_group`, the video axis split)."""
    from deflicker_torch.atlas.multifit import fit_group
    from deflicker_torch.atlas.render import render_frames
    from deflicker_torch.filter.engine import FilterEngine
    from deflicker_torch.flow import RAFTFlow
    from deflicker_torch.models import raft_init, transformnet_init, unet_init
    from deflicker_torch.ops.pad import Padder
    from deflicker_torch.parallel import (batch_sharding, data_axis_sharding,
                                          replicated, shard_constraint)
    from deflicker_torch.parallel.mesh import broadcast_object

    out = {}
    x = torch.arange(7.0) + 10 * mesh.rank
    mine = batch_sharding(x, mesh)
    out["block"] = mine.tolist()
    out["gathered"] = shard_constraint(mine, mesh).tolist()
    y = torch.arange(10.0).reshape(2, 5) + 100 * mesh.rank
    out["gathered_axis1"] = shard_constraint(
        data_axis_sharding(y, mesh, 1), mesh, 1, 5).tolist()
    out["replicated"] = replicated(x.clone(), mesh).tolist()
    out["summed"] = all_reduce_sum(torch.ones(3) * (mesh.rank + 1),
                                   mesh).tolist()
    out["object"] = broadcast_object({"rank": mesh.rank}, mesh)

    specs = teng.build_specs(cfg)
    T, (H, W) = data.num_frames, data.res
    out["render"] = render_frames(atlas_params_from_jax(host), specs, T, H, W,
                                  rows_per_call=2 * H * W, mesh=mesh)

    flow = RAFTFlow(model=raft_init(torch.Generator().manual_seed(0)),
                    iters=2, dtype=torch.float32, device="cpu", mesh=mesh)
    out["raft"] = flow.compute_batch(*pairs)

    gen = torch.Generator().manual_seed(0)
    engine = FilterEngine(unet_init(gen), transformnet_init(gen), batch=2,
                          mesh=mesh)
    content, style = frames
    out["unet"] = engine._filter_all(content, style,
                                     Padder(*content.shape[1:3], divisor=32,
                                            mode="other")).numpy()

    gcfg = dataclasses.replace(cfg, iters_num=4, steps_per_call=2,
                               evaluate_every=3, pretrain_iter_number=1,
                               samples_batch=64, stop_global_rigidity=1)
    gens = tuple(torch.Generator().manual_seed(s) for s in range(4))
    fit = fit_group(datas_v, specs, gcfg, gens, "cpu", mesh=mesh)
    out["group"] = [(_params_np(r.params), [x["total"] for x in r.logs])
                    for r in fit["results"]]
    return out


def serve(mesh, tmp, config, lines):
    """A `Deflickerer` over the ranks answering `lines` through
    `serve_lines`: what this rank printed and how many jobs it ran."""
    import io

    from deflicker_torch.api import Deflickerer
    from deflicker_torch.cli.serve import serve_lines

    d = Deflickerer(ckpt_raft=f"{tmp}/missing/r.pth",
                    ckpt_filter=f"{tmp}/missing/f.pth",
                    ckpt_local=f"{tmp}/missing/l.pth", config=config,
                    root=f"{tmp}/data", results_root=f"{tmp}/served",
                    device="cpu", mesh=mesh)
    buf = io.StringIO()
    n = serve_lines(d, lines if mesh.rank == 0 else [], out=buf)
    return {"printed": buf.getvalue(), "n": n, "mesh": d.mesh.shape}


class _FakeGraph:
    """A stand-in for a captured CUDA graph: its replay runs `fn`."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


class _RankGraphs(FitGraphs):
    """`FitGraphs` that capture on the CPU with the backend gate lifted:
    the capture records the step (and launches nothing), a replay runs it.
    Records the backend each gate was asked about and the all-reduces each
    replay ran (`counter`, a one-item list the caller's counted
    `all_reduce` adds to)."""

    def __init__(self, counter):
        super().__init__()
        self.counter = counter
        self.backends, self.per_replay = [], []

    def uncaptured(self, device, backend=None):
        self.backends.append(backend)
        return None

    def warm_up(self, state, fn):
        fn()

    def _record(self, state, fn):
        return _FakeGraph(fn)

    def replay(self, state, graph, n):
        for _ in range(n):
            before = self.counter[0]
            graph.replay()
            self.per_replay.append(self.counter[0] - before)


def graph_fit(mesh, host, cfg, data):
    """The sample-sharded single fit twice from one generator: through the
    stand-in graphs (`_RankGraphs`) and eagerly (`FitGraphs(eager=True)`),
    with every `all_reduce` counted: each run's params, logs, all-reduce
    count and graphs captured, and the stand-in's gate backends and
    all-reduces a replay."""
    import torch.distributed as dist

    counter = [0]
    real = dist.all_reduce

    def counted(*args, **kw):
        counter[0] += 1
        return real(*args, **kw)

    dist.all_reduce = counted
    try:
        specs = teng.build_specs(cfg)
        fake = _RankGraphs(counter)
        out = {}
        for name, graphs in (("captured", fake),
                             ("eager", FitGraphs(eager=True))):
            p = atlas_params_from_jax(host)
            counter[0] = 0
            res = teng.fit_atlas(p, specs, data, cfg,
                                 torch.Generator().manual_seed(5), mesh=mesh,
                                 graphs=graphs)
            out[name] = {"params": _params_np(p), "logs": res.logs,
                         "all_reduces": counter[0],
                         "captured": graphs.captured}
    finally:
        dist.all_reduce = real
    out["backends"], out["per_replay"] = fake.backends, fake.per_replay
    return out
