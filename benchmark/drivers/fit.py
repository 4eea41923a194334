"""Traffic of kind "fit": the stage-1 atlas fit, job after job, closed loop.

Each job is what a warm server runs for one video (or, with `videos` > 1,
one V-batched group, as the batch CLI's `--parallel_fit` runs it): fresh
networks drawn from the seed, the published schedule from iteration 0,
through `fit_atlas` (`fit_atlas_multi`) and one kept `FitGraphs`, so every
job replays the graphs that set-up captured.  When a job ends the next one
starts; the window closes at the first chunk's host sync past `seconds`.

Set-up makes the clips and their gather pack on the device, then drives
the kept graphs through the fit's first three steps (steps 0-1 eager, step
2 captured), whose losses, first gradient (from Adam's first moment after
one step) and parameter change the reference checks once the window has
closed, and through three steps of every later loss phase, so that the
window captures nothing.

Calibration (`benchmark/calibrate.py`): `sound` is that probe and its
reference, `control` the reference one precision below in the program's
place, and `faults` the fit's faults planted under the timed path.

Traffic parameters: "videos" (V), "frames" (T).  The configuration gives
the pipeline, the clip, the frame size, `down` and the atlas settings.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Callable, Dict, List, Optional
from unittest import mock

import numpy as np
import torch

from ..core import trace as tracing
from ..core.seeds import sub_seed
from ..data.clips import fit_pack, make_clips
from ..reference import nla

PROBE_STEPS = 3
PROFILE_SPAN = 100      # profiled steps either side of global rigidity's stop
BETA1 = nla.ADAM[0]


class _WindowClosed(Exception):
    pass


def _host_shapes(lead: tuple, T: int, h: int, w: int):
    """The fit's host arrays, for their shapes only: the fit reads the pack
    on the device and takes sizes from these (evaluation, which reads them,
    is not part of this traffic)."""
    from deflicker_torch.atlas.data import VideoData

    z = np.zeros((), np.float32)
    s = lead + (T, h, w)
    return VideoData(*(np.broadcast_to(z, s + c) for c in
                       ((3,), (3,), (3,), (), (2,), (2,), (), ())))


class Program:
    """The measured fit entry (`fit_atlas`, or `fit_atlas_multi` for V > 1)
    over one kept `FitGraphs`, with the clip pack as its data."""

    def __init__(self, atlas: dict, dual: bool, pack: torch.Tensor, rescue: str):
        from deflicker_torch.atlas.engine import build_specs
        from deflicker_torch.atlas.graphs import FitGraphs
        from deflicker_torch.config import AtlasConfig

        self.cfg = AtlasConfig(**atlas)
        self.specs = build_specs(self.cfg, dual)
        self.V = pack.shape[0]
        T, h, w = pack.shape[1:4]
        if self.V == 1:
            self.data = _host_shapes((), T, h, w)._replace(packed=pack[0])
        else:
            self.data = _host_shapes((self.V,), T, h, w)._replace(packed=pack)
        self.graphs = FitGraphs(keep=True)
        self.rescue = rescue

    def params(self, stacked: Dict[str, list]) -> Dict[str, list]:
        """The program's parameter tree from the harness's (V, ...) leaves."""
        take = (lambda t: t[0]) if self.V == 1 else (lambda t: t)
        return {name: [{k: take(t).detach().clone().requires_grad_()
                        for k, t in layer.items()} for layer in layers]
                for name, layers in stacked.items()}

    def fit(self, params, generator, start: int, end: int,
            opt_state=None, on_chunk: Optional[Callable[[int], None]] = None,
            steps_per_call: Optional[int] = None):
        """Steps [start, end) of one job.  Returns (each chunk's mean loss
        terms [[{term: value} of each video]], the stacked host Adam state)."""
        from deflicker_torch.atlas.engine import fit_atlas
        from deflicker_torch.atlas.multifit import fit_atlas_multi

        cfg = dataclasses.replace(
            self.cfg, iters_num=end,
            steps_per_call=steps_per_call or self.cfg.steps_per_call)
        losses: List[List[dict]] = []
        if self.V == 1:
            def log(it, rec):
                losses.append([rec])
                if on_chunk is not None:
                    on_chunk(it)
            res = fit_atlas(params, self.specs, self.data, cfg, generator,
                            start_iteration=start, opt_state=opt_state,
                            log_callback=log, rescue_path=self.rescue,
                            graphs=self.graphs)
            return losses, res.opt_state
        state = {}

        def log_v(it, v, rec):
            if v == 0:
                losses.append([])
            losses[-1].append(rec)
            if v == self.V - 1 and on_chunk is not None:
                on_chunk(it)
        fit_atlas_multi(params, self.specs, self.data, cfg, generator,
                        start_iteration=start, opt_state_v=opt_state,
                        log_callback=log_v,
                        checkpoint_callback=lambda i, st: state.update(st),
                        rescue_path=self.rescue, graphs=self.graphs)
        return losses, state["opt_state_v"]

    def leaves(self, params) -> Dict[str, torch.Tensor]:
        """The program's parameters by the reference's leaf names, (V, ...)."""
        add = (lambda t: t[None]) if self.V == 1 else (lambda t: t)
        return {k: add(t.detach()) for k, t in nla.leaves(params).items()}

    def adam_moments(self, opt_state, params) -> Dict[str, torch.Tensor]:
        """Adam's first moments by leaf name: the host state lists them in
        the program's order (networks by name, layers, then w and b)."""
        names = [f"{name}.{k}.{key}" for name in sorted(params)
                 for k in range(len(params[name])) for key in ("w", "b")]
        add = (lambda a: a[None]) if self.V == 1 else (lambda a: a)
        return {n: torch.from_numpy(np.asarray(add(m)))
                for n, m in zip(names, opt_state["exp_avg"])}


def _draws(generator, shape, T, H, W, device, n):
    """The samples the fit step draws, in its order (j, i, f), n steps."""
    out = []
    for _ in range(n):
        j = torch.randint(0, W, shape, generator=generator, device=device)
        i = torch.randint(0, H, shape, generator=generator, device=device)
        f = torch.randint(0, T, shape, generator=generator, device=device)
        out.append(tuple(t.reshape(-1, shape[-1]) for t in (j, i, f)))
    return out


def _phase_starts(atlas: dict, dual: bool) -> Dict[tuple, int]:
    """The first iteration of every loss phase the schedule reaches."""
    starts = {}
    for it in sorted({0, atlas["stop_global_rigidity"] + 1,
                      atlas["stop_bootstrapping_iteration"] + 1}):
        if it < atlas["iters_num"]:
            starts.setdefault(nla.phase(atlas, dual, it), it)
    return starts


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[tuple, float]:
    """The norm of every leaf, each video's own: {(name, video): norm}."""
    return {(k, v): float(t[v].double().norm())
            for k, t in leaves.items() for v in range(t.shape[0])}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              kept) -> Dict[tuple, float]:
    """|‖prog‖ - ‖ref‖| over the larger of the reference leaf's norm and the
    median leaf's, for every kept leaf."""
    pn, rn = _norms(prog), _norms(ref)
    med = float(np.median([rn[k] for k in kept]))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in kept}


def kept_leaves(ref_grad: Dict[str, torch.Tensor]) -> list:
    """The leaves that count: those whose reference gradient is at least a
    thousandth of the median leaf's (a gradient that is nought to rounding,
    as a bias's under a softmax, moves a leaf under Adam by round-off)."""
    norms = _norms(ref_grad)
    med = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def inputs(cell, seed: int, device) -> types.SimpleNamespace:
    """The cell's clips, their pack and the sizes the draws need."""
    config, traffic = cell.config, cell.traffic
    atlas = dict(config["atlas"])
    V, T = traffic["videos"], traffic["frames"]
    clips = make_clips(config["clip"], V, T, config["frame_size"],
                       config["down"], seed, device)
    pack = fit_pack(clips)
    return types.SimpleNamespace(
        seed=seed, device=device, atlas=atlas, V=V, T=T, clips=clips, pack=pack,
        dual=config["pipeline"] == "dual", hw=tuple(pack.shape[2:4]),
        shape=((atlas["samples_batch"],) if V == 1
               else (V, atlas["samples_batch"])))


def job(inp, tag: str, *names):
    """A job's fresh networks (the harness's (V, ...) leaves) and its
    samples' generator, from the run's seed."""
    params = nla.init_params(inp.atlas, inp.dual, inp.V,
                             torch.Generator(device=inp.device).manual_seed(
                                 sub_seed(inp.seed, tag, *names, "init")),
                             inp.device)
    gen = torch.Generator(device=inp.device).manual_seed(
        sub_seed(inp.seed, tag, *names, "samples"))
    return params, gen


def probe(prog: Program, inp, parts: Optional[dict] = None):
    """The fit's first three steps through the window's entry and graphs:
    ({"losses", "grad", "params"}, the initial networks, the samples' seed).
    `parts` receives the seconds of the first step and of the other two."""
    params0, gen = job(inp, "probe")
    probe_seed = gen.initial_seed()
    p = prog.params(params0)
    t0 = time.perf_counter()
    losses, opt1 = prog.fit(p, gen, 0, 1, steps_per_call=1)
    moments = prog.adam_moments(opt1, p)
    t1 = time.perf_counter()
    more, _ = prog.fit(p, gen, 1, PROBE_STEPS, opt_state=opt1, steps_per_call=1)
    if parts is not None:
        parts["first_step"] = t1 - t0
        parts["steps_1_2"] = time.perf_counter() - t1
    return ({"losses": losses + more,
             "grad": {k: m / (1.0 - BETA1) for k, m in moments.items()},
             "params": {k: t.cpu() for k, t in prog.leaves(p).items()}},
            params0, probe_seed)


# the reference's products at each of the configuration's fit precisions
PRECISION = {"default": "bf16", "highest": "f32"}


def reference(inp, params0, probe_seed: int, precision: Optional[str] = None) -> dict:
    """The plain reference's first three steps on the same networks and
    draws, its products at the configuration's precision (or `precision`:
    the control's)."""
    T, (h, w) = inp.T, inp.hw
    samples = _draws(torch.Generator(device=inp.device).manual_seed(probe_seed),
                     inp.shape, T, h, w, inp.device, PROBE_STEPS)
    return nla.fit_steps(params0, inp.atlas, inp.clips, samples,
                         precision=precision or PRECISION[inp.atlas["fit_precision"]])


def as_probe(ref: dict) -> dict:
    """A reference run in `probe`'s form (the control in the program's place)."""
    steps = []
    for total, terms in zip(ref["losses"], ref["terms"]):
        steps.append([dict({k: float(t[v]) for k, t in terms.items()},
                           total=float(total[v])) for v in range(total.shape[0])])
    return {"losses": steps, "grad": ref["grad"],
            "params": {k: t.cpu() for k, t in ref["params"].items()}}


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_process: float) -> dict:
    parts = {"start": time.perf_counter() - t_process}
    t = time.perf_counter()
    inp = inputs(cell, seed, device)
    atlas = inp.atlas
    prog = Program(atlas, inp.dual, inp.pack, str(cell.scratch / "rescue"))
    parts["inputs"], t = time.perf_counter() - t, time.perf_counter()
    found, params0, probe_seed = probe(prog, inp, parts)
    t = time.perf_counter()
    # every later loss phase's graph
    for start in _phase_starts(atlas, inp.dual).values():
        if start > 0:
            params, g = job(inp, "warm", start)
            prog.fit(prog.params(params), g, start, start + 3)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    parts["warm"] = time.perf_counter() - t

    # the window: job after job
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    deadline = t0 + seconds
    spans, attempted, failed, last = [], 0, 0, {}

    def on_chunk(it):
        last["it"] = it
        if time.perf_counter() >= deadline:
            raise _WindowClosed

    while True:
        attempted += 1
        params, g = job(inp, "job", attempted)
        last.clear()
        try:
            prog.fit(prog.params(params), g, 0, atlas["iters_num"],
                     on_chunk=on_chunk)
            spans.append((0, atlas["iters_num"]))
        except _WindowClosed:
            spans.append((0, last["it"] + 1))
            break
        except FloatingPointError:
            failed += 1
            spans.append((0, last.get("it", -1) + 1))
    t1 = time.perf_counter()
    steps = sum(e - s for s, e in spans)
    window = {"seconds": t1 - t0, "spans": spans, "videos": inp.V,
              "video_steps": inp.V * steps}

    traced = None
    if trace:
        # one job's steps around global rigidity's stop, in chunks of
        # PROFILE_SPAN; the profile spans the chunk before the stop and the
        # one after it, from one chunk's host sync to another's, so neither
        # the job's start nor its end is in it
        mid = atlas["stop_global_rigidity"] + 1
        lo, hi = mid - PROFILE_SPAN, mid + PROFILE_SPAN
        traced = {}
        session = tracing.Session(traced, "fit")
        opened = []

        def profile_chunk(it):
            # the profile opens at the first chunk end at or past lo and
            # closes at the first at or past hi
            if not opened and it + 1 >= lo:
                session.start()
                opened.append(it + 1)
            elif len(opened) == 1 and it + 1 >= hi:
                session.stop()
                opened.append(it + 1)
                traced["spans"] = [tuple(opened)]

        params, g = job(inp, "profile")
        prog.fit(prog.params(params), g, lo - PROFILE_SPAN, hi + PROFILE_SPAN,
                 on_chunk=profile_chunk, steps_per_call=PROFILE_SPAN)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del prog
    inp.pack = None
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference follows the first three steps
    checks = readings(found, reference(inp, params0, probe_seed), params0)
    return {"e2e": {"fit_its": window["video_steps"] / window["seconds"]},
            "setup_s": setup_s, "window": window, "trace": traced,
            "checks": checks, "attempted": attempted, "failed": failed,
            "memory_peak_bytes": peak, "setup_parts": parts}


def term_gaps(probe: dict, ref: dict) -> Dict[str, float]:
    """Each loss term's worst relative gap over the steps and videos ("total"
    the loss itself)."""
    out = {}
    for n, (recs, terms) in enumerate(zip(probe["losses"], ref["terms"])):
        want = dict(terms, total=ref["losses"][n])
        for k, t in want.items():
            for v, rec in enumerate(recs):
                r = float(t[v])
                gap = abs(rec[k] - r) / abs(r)
                out[k] = max(out.get(k, 0.0), gap)
    return out


def readings(probe: dict, ref: dict, params0: Dict[str, list]) -> Dict[str, float]:
    """The numbers compared: the worst relative gap of a step's loss; the
    gap of the first gradient's norm at its worst leaf and at its median
    leaf; the worst leaf's gap of the three steps' parameter change.  The
    worst leaf is always one of mapping1's whose gradient comes through the
    rigidity terms' one-pixel differences, and it swings from seed to seed;
    the median leaf is steady, and it is the number that a step over half
    the batch fails."""
    gaps = term_gaps(probe, ref)
    start = {k: t.detach().cpu() for k, t in nla.leaves(params0).items()}
    ref_grad = {k: t.cpu() for k, t in ref["grad"].items()}
    kept = kept_leaves(ref_grad)
    grad = leaf_gaps({k: t.cpu() for k, t in probe["grad"].items()}, ref_grad,
                     kept)
    update = leaf_gaps({k: probe["params"][k] - start[k] for k in start},
                       {k: ref["params"][k].cpu() - start[k] for k in start},
                       kept)
    return {"loss_gap": gaps["total"], "grad_gap": max(grad.values()),
            "grad_median_gap": float(np.median(list(grad.values()))),
            "update_gap": max(update.values())}


def detail(found: dict, ref: dict, params0) -> dict:
    """Where the readings come from: each step's loss gap, the median kept
    leaf's gradient and change gaps, and the three worst leaves."""
    start = {k: t.detach().cpu() for k, t in nla.leaves(params0).items()}
    ref_grad = {k: t.cpu() for k, t in ref["grad"].items()}
    kept = kept_leaves(ref_grad)
    out = {"term_gaps": term_gaps(found, ref),
           "kept": len(kept), "leaves": sum(t.shape[0] for t in ref_grad.values())}
    for name, (p, r) in {
            "grad": ({k: t.cpu() for k, t in found["grad"].items()}, ref_grad),
            "update": ({k: found["params"][k] - start[k] for k in start},
                       {k: ref["params"][k].cpu() - start[k] for k in start})}.items():
        gaps = leaf_gaps(p, r, kept)
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        out[name + "_median_leaf_gap"] = float(np.median(list(gaps.values())))
        out[name + "_worst"] = [[f"{k[0]}[{k[1]}]", v] for k, v in worst]
    return out


def sound(cell, seed: int, seconds: float, device):
    """A sound run's readings of the fit's first three steps (the probe that
    a benchmark run makes in set-up; no window), and their detail."""
    inp = inputs(cell, seed, device)
    prog = Program(inp.atlas, inp.dual, inp.pack, str(cell.scratch / "rescue"))
    found, params0, probe_seed = probe(prog, inp)
    del prog
    inp.pack = None
    ref = reference(inp, params0, probe_seed)
    return readings(found, ref, params0), {"detail": detail(found, ref, params0)}


def control(cell, seed: int, device):
    """The control's readings: the reference with fp8 products in the
    program's place, against the reference at the configuration's
    precision."""
    inp = inputs(cell, seed, device)
    params0, gen = job(inp, "probe")
    ref = reference(inp, params0, gen.initial_seed())
    low = as_probe(reference(inp, params0, gen.initial_seed(), precision="fp8"))
    return readings(low, ref, params0), {"detail": detail(low, ref, params0)}


def state_unchanged():
    """Every optimizer step leaves the parameters as they were."""
    step = torch.optim.Adam.step

    def frozen(self, *args, **kwargs):
        params = [p for g in self.param_groups for p in g["params"]]
        saved = [p.detach().clone() for p in params]
        out = step(self, *args, **kwargs)
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
        return out
    return mock.patch.object(torch.optim.Adam, "step", frozen)


def half_batch():
    """The loss takes the first half of the sampled pixels and its means
    over them."""
    from deflicker_torch.atlas import engine

    make_loss_fn = engine.make_loss_fn

    def half(*args, **kwargs):
        loss_fn = make_loss_fn(*args, **kwargs)

        def on_half(params, packed, j, i, f, norm=None):
            n = j.shape[-1] // 2
            return loss_fn(params, packed, j[..., :n], i[..., :n], f[..., :n], norm)
        return on_half
    return mock.patch.object(engine, "make_loss_fn", half)


def faults(cell) -> dict:
    """Faults planted under the timed path, name -> context manager factory."""
    return {"state_unchanged": state_unchanged, "half_batch": half_batch}
