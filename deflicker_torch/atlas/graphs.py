"""CUDA graphs of the stage-1 fit: the counterpart of the JAX package's
scanned chunks (`make_scan_step` + `_run_chunk` and the scanned
`pretrain_mapping` in deflicker_tpu/atlas/engine.py, `_run_chunk_multi` in
its atlas/multifit.py).

A `lax.scan` chunk is one device program of `n_steps` steps.  Here one
step is captured once as a `torch.cuda.CUDAGraph` and replayed `n_steps`
times, so a step costs the host one replay call instead of some 600
dispatched ops:

  * `CapturedStep.run(graphs, state, n)` runs a step function n times.  Its first
    `WARMUP_STEPS` steps run eagerly on the capture stream; they are real
    steps of the fit, and everything a step builds once on the host comes
    to exist in them (the loss's offset constants, the kernel library and
    its tensor-map entry point, Adam's state).  Then the step is captured
    (capture runs nothing) and every later step is one replay.  The step's
    generator is registered with the graph, so the replays draw what eager
    steps would draw and leave the generator's state where eager steps
    would;
  * the chain wrappers count their launches in Python, once at capture
    and never at replay: the capture's count is taken back and each replay
    adds that step's launches;
  * the counters of `utils/trace.py` add up the host's graph set-up:
    `graphs.warmup_s` and `graphs.capture_s` (the host seconds of the
    eager warm-up steps and of the captures, no sync added), and
    `graphs.state_made`, `graphs.state_loaded` and `graphs.evicted` (fit
    states and inference keys made, reused and dropped, of a kept
    `FitGraphs` and an `InferenceGraphs`); `cli.serve` reports each job's
    share of them, so a warm server whose `state_made` rises is capturing
    again;
  * a `FitState` holds what the graphs read at fixed addresses: the
    params, the Adam state, the pack, the generator, and one memory pool
    for every graph of the fit (one a loss phase);
  * `FitGraphs` makes the states.  A fit's own (`keep=False`, what the
    one-shot entry points use) adopts the caller's tensors and captures
    once per fit.  A kept one (`keep=True`, a `Deflickerer`'s) keys its
    states by the fit's shape, as the JAX package's jit cache keys its
    compiles: a later fit of that shape copies its pack, params and
    generator state in, zeroes Adam's state in place and replays the
    graphs already captured (`_run_chunk` takes the data as a traced input
    for the same reason: "one compile serves any video content of this
    shape").  It keeps the states of one job at most (`MAX_STATES`), and
    no state refers back to the `FitGraphs`, so dropping it frees every
    state's pack, params and graph pool at once.

The same `FitGraphs` serve stage-2 training (train/stage2_trainer.py),
the counterpart of the JAX package's scanned `_filter_chunk` and
`_refiner_chunk`: a run's state holds its net's params, their fused
capturable Adam, the LR as a 0-d device tensor the host fills before each
step, the clip source's device generator and bank indices, and one step
function a clip kind (image bank, Fourier clips).  The host's coin picks
the kind before each step, so the two graphs replay in the coin's order,
one memory pool and one generator between them; each kind pays its own
warm-up the first time the coin picks it.  A run's graphs go with the run.

The sample-sharded fit's step, with its gradient all-reduce, is captured
under NCCL: the warm-up steps make NCCL's communicator, and the collective
is recorded on the capture stream like any kernel.

Where a step cannot be captured it runs eagerly, and the run says why on
one line to stderr (`FitGraphs.uncaptured`): on the CPU, under autograd's
anomaly mode (DEFLICKER_DEBUG_NANS: it syncs at every node of the
backward), and in the sample-sharded fit under gloo (which stages the
all-reduce through the host).  A capture that fails on the card raises.

The same warm-up, capture, replay and counter accounting (`Graphs`)
serve the inference engines, the counterparts of the JAX package's jitted
RAFT solve and its refinement scans (`InferenceGraphs`): a RAFT solve
(flow/engine.py) and a refinement step (filter/engine.py) are captured
without a generator, each keyed by what it bakes in.  A key's first call
runs eagerly (its warm-up, whose result is used) and the key is captured
straight after it, so every later call of that key, in this job or a
later one, is one replay.  Inference has no backward, so only the CPU (or
a caller asking for eager steps) keeps them uncaptured.
"""

from __future__ import annotations

import sys
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops.cuda import attention_kernel, corr_kernel, imlp_kernel
from ..utils import trace

# eager steps before a fit's step function is captured
WARMUP_STEPS = 2
# eager calls before an inference step is captured: it has no optimizer
# state or generator to settle; its first call loads the kernel library,
# picks cuDNN's algorithms and sizes cuBLAS's workspace
WARMUP_CALLS = 1
# the launch counters a captured step accounts for
COUNTERS = (imlp_kernel.launches, corr_kernel.launches,
            attention_kernel.launches)
# states a kept `FitGraphs` holds: the most one job makes, its fit's and a
# pretrain's for each of its two mappings (the least recently used goes
# first: each holds a copy of its pack and its graphs' memory)
MAX_STATES = 3
# keys an `InferenceGraphs` keeps: a job's full and tail batch of pairs
# under two correlation bodies (the least recently used goes first: each
# holds its static buffers)
MAX_KEYS = 4


def say_uncaptured(what: str, reason: str) -> None:
    """The one line an uncaptured run prints, to stderr (a diagnostic: the
    CLIs' stdout carries their results)."""
    print(f"[deflicker_torch] {what} run uncaptured: {reason}",
          file=sys.stderr, flush=True)


def _leaves(tree) -> List[torch.Tensor]:
    """Every tensor of a params tree ({name: [layer]} or [layer]), in a
    fixed order."""
    if isinstance(tree, dict):
        return [t for name in sorted(tree) for t in _leaves(tree[name])]
    return [layer[k] for layer in tree for k in ("w", "b")]


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {name: _clone_tree(sub) for name, sub in tree.items()}
    return [{k: t.detach().clone().requires_grad_(t.requires_grad)
             for k, t in layer.items()} for layer in tree]


class GraphState:
    """Where graphs are captured: the device, the one memory pool of the
    graphs captured here, and the generator they draw from (None: they
    draw nothing)."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.device = device
        self.generator = generator
        self.pool = None


class FitState(GraphState):
    """What one fit's graphs read, at fixed addresses: `params` (a params
    tree), `optimizer` over its leaves, `generator` (the samples' draws),
    `tensors` (the pack, counters, chunk sums), the step functions by loss
    phase (`steps`) and the graphs' one memory pool."""

    def __init__(self, params, optimizer, generator: torch.Generator,
                 tensors: Dict[str, torch.Tensor]):
        super().__init__(_leaves(params)[0].device, generator)
        self.params = params
        self.optimizer = optimizer
        self.tensors = tensors
        self.steps: Dict[object, "CapturedStep"] = {}

    def load(self, params, generator: torch.Generator,
             tensors: Dict[str, torch.Tensor]) -> None:
        """A new fit of this shape: its params, tensors and generator state
        copied in (the addresses stay)."""
        with torch.no_grad():
            for mine, theirs in zip(_leaves(self.params), _leaves(params)):
                mine.copy_(theirs)
            for name, t in tensors.items():
                self.tensors[name].copy_(t)
        self.generator.set_state(generator.get_state())

    def store(self, params, generator: torch.Generator) -> None:
        """The state's params and generator state copied back to the
        caller's (nothing to copy where the state adopted them)."""
        if _leaves(params)[0] is not _leaves(self.params)[0]:
            with torch.no_grad():
                for theirs, mine in zip(_leaves(params), _leaves(self.params)):
                    theirs.copy_(mine)
        if generator is not self.generator:
            generator.set_state(self.generator.get_state())


class Graphs:
    """Warm-up, capture and replay of step functions on the card, and the
    launch counters' accounting (see the module docstring).  `captured`
    counts the graphs captured.  A CPU test replaces `warm_up`, `_record`
    and `replay`."""

    def __init__(self):
        self.captured = 0
        self._streams: Dict[torch.device, object] = {}

    def _stream(self, device: torch.device):
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def warm_up(self, state: GraphState, fn: Callable) -> None:
        """One eager step on the capture stream."""
        with torch.cuda.device(state.device):
            stream = self._stream(state.device)
            main = torch.cuda.current_stream()
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                fn()
            main.wait_stream(stream)

    def _record(self, state: GraphState, fn: Callable):
        """Capture `fn` into a graph in the state's memory pool, drawing
        from the state's generator when it has one."""
        with torch.cuda.device(state.device):
            if state.pool is None:
                state.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            if state.generator is not None:
                graph.register_generator_state(state.generator)
            with torch.cuda.graph(graph, pool=state.pool,
                                  stream=self._stream(state.device)):
                fn()
        return graph

    def replay(self, state: GraphState, graph, n: int) -> None:
        with torch.cuda.device(state.device):
            for _ in range(n):
                graph.replay()

    def capture(self, state: GraphState, fn: Callable
                ) -> Tuple[object, List[Tuple[dict, dict]]]:
        """(graph, per-counter launches of one step).  The launches the
        wrappers counted while capturing are taken back: capture launches
        nothing."""
        before = [dict(c) for c in COUNTERS]
        t0 = time.perf_counter()
        graph = self._record(state, fn)
        trace.add_seconds("graphs.capture_s", time.perf_counter() - t0)
        counts = []
        for c, b in zip(COUNTERS, before):
            delta = {k: c[k] - b[k] for k in c if c[k] != b[k]}
            for k, v in delta.items():
                c[k] -= v
            if delta:
                counts.append((c, delta))
        self.captured += 1
        return graph, counts


class FitGraphs(Graphs):
    """The CUDA graphs of stage-1 fits and pretrains, and of stage-2
    training runs, on one process (see the module docstring).
    `keep=False`: the graphs of one fit.
    `keep=True`: states kept by the fit's shape across fits, at most
    `MAX_STATES` of them.  `eager=True` captures
    nothing (the eager fit that the card's tests and chip_smoke compare the
    captured one with)."""

    def __init__(self, keep: bool = False, eager: bool = False):
        super().__init__()
        self.keep = keep
        self.eager = eager
        self.states: "OrderedDict[tuple, FitState]" = OrderedDict()

    # -- when to capture --------------------------------------------------
    def uncaptured(self, device: torch.device,
                   backend: Optional[str] = None) -> Optional[str]:
        """Why steps on `device` cannot be captured; None when they can.
        `backend`: the sample-sharded fit's process group backend (None:
        no collective in the step)."""
        if device.type != "cuda":
            return "the CPU has no CUDA graphs"
        if torch.is_anomaly_enabled():
            return ("autograd's anomaly mode (DEFLICKER_DEBUG_NANS) syncs at "
                    "every node of the backward")
        if backend not in (None, "nccl"):
            return (f"{backend} stages the sample-sharded fit's gradient "
                    "all-reduce through the host")
        return None

    def capturing(self, device: torch.device, what: str,
                  backend: Optional[str] = None) -> bool:
        """Whether `what` (a fit, a pretrain, a training run) is captured.
        An uncaptured run says so and why on one line."""
        reason = ("the caller asked for it" if self.eager
                  else self.uncaptured(device, backend))
        if reason is not None:
            say_uncaptured(f"{what} steps", reason)
        return reason is None

    # -- states -----------------------------------------------------------
    def state(self, key: tuple, params, generator: torch.Generator,
              make_optimizer: Callable, **tensors) -> FitState:
        """The state of a fit of shape `key` over `params`, `generator` and
        `tensors`: the caller's own when not kept; when kept, the state of
        the first fit of this shape (its own copies) with this fit's
        values copied in."""
        if not self.keep:
            return FitState(params, make_optimizer(params), generator, tensors)
        st = self.states.get(key)
        if st is not None:
            self.states.move_to_end(key)
            st.load(params, generator, tensors)
            trace.count("graphs.state_loaded")
            return st
        trace.count("graphs.state_made")
        mine = _clone_tree(params)
        gen = torch.Generator(device=generator.device)
        gen.set_state(generator.get_state())
        st = FitState(mine, make_optimizer(mine), gen,
                      {name: t.clone() for name, t in tensors.items()})
        self.states[key] = st
        while len(self.states) > MAX_STATES:
            self.states.popitem(last=False)
            trace.count("graphs.evicted")
        return st

class CapturedStep:
    """A step function run n steps at a time (see the module docstring).
    `run` takes the `Graphs` and the state whose graphs hold this one
    rather than keeping them, so that no reference cycle outlives a fit:
    with `graphs` None the steps run eagerly, else `warmup` eager steps,
    one capture, then replays, in the state's graphs."""

    def __init__(self, step: Callable, warmup: int = WARMUP_STEPS):
        self.step = step
        self.warmup = warmup
        self.graph = None
        self.warm = 0
        self.counts: List[Tuple[dict, dict]] = []

    def run(self, g: Optional[Graphs], state: GraphState, n: int) -> None:
        if g is None:
            for _ in range(n):
                self.step()
            return
        while n > 0 and self.warm < self.warmup:
            t0 = time.perf_counter()
            g.warm_up(state, self.step)
            trace.add_seconds("graphs.warmup_s", time.perf_counter() - t0)
            self.warm += 1
            n -= 1
        if n > 0:
            self.ensure_captured(g, state)
            g.replay(state, self.graph, n)
            for counters, delta in self.counts:
                for k, v in delta.items():
                    counters[k] += v * n

    def ensure_captured(self, g: Graphs, state: GraphState) -> None:
        """Capture the step once its warm-up steps have run (capture runs
        nothing)."""
        if self.graph is None and self.warm >= self.warmup:
            self.graph, self.counts = g.capture(state, self.step)


class InferenceGraphs(Graphs):
    """The captured steps of one inference engine on `device`, by the key
    of what each bakes in (`entry`), at most `MAX_KEYS` of them, the least
    recently used going first; all in one memory pool.  A step reads and
    writes only static buffers allocated outside its capture and leaves
    nothing alive in the pool, so the graphs can share the pool and replay
    in any order (one at a time, in stream order).  `capture` None means
    on the card; uncaptured, `what` says so and why on one printed line."""

    def __init__(self, device: torch.device, what: str,
                 capture: Optional[bool] = None):
        super().__init__()
        self.state = GraphState(torch.device(device))
        self.entries: "OrderedDict[tuple, object]" = OrderedDict()
        if capture is None:
            capture = self.state.device.type == "cuda"
        self.enabled = capture
        if not capture:
            say_uncaptured(what, "the CPU has no CUDA graphs"
                           if self.state.device.type != "cuda"
                           else "the caller asked for it")

    def entry(self, key: tuple, make: Callable):
        """The entry (static buffers and a `CapturedStep` as `.step`) of
        `key`, made by `make()` the first time."""
        e = self.entries.get(key)
        if e is None:
            trace.count("graphs.state_made")
            e = self.entries[key] = make()
            while len(self.entries) > MAX_KEYS:
                self.entries.popitem(last=False)
                trace.count("graphs.evicted")
        else:
            trace.count("graphs.state_loaded")
            self.entries.move_to_end(key)
        return e

    def run(self, step: CapturedStep, n: int = 1) -> None:
        """`step` n times: its first call eagerly, then captured at once
        (used or not in this call), then replays."""
        step.run(self, self.state, n)
        step.ensure_captured(self, self.state)
