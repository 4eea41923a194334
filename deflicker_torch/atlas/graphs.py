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

Where a step cannot be captured it runs eagerly, and the fit says why on
one printed line (`FitGraphs.uncaptured`): on the CPU, under autograd's
anomaly mode (DEFLICKER_DEBUG_NANS: it syncs at every node of the
backward), and in the sample-sharded fit (its gradient all-reduce).  A
capture that fails on the card raises.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops.cuda import imlp_kernel

# eager steps before a step function is captured
WARMUP_STEPS = 2
# the launch counters a captured step accounts for
COUNTERS = (imlp_kernel.launches,)
# states a kept `FitGraphs` holds: the most one job makes, its fit's and a
# pretrain's for each of its two mappings (the least recently used goes
# first: each holds a copy of its pack and its graphs' memory)
MAX_STATES = 3


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


class FitState:
    """What one fit's graphs read, at fixed addresses: `params` (a params
    tree), `optimizer` over its leaves, `generator` (the samples' draws),
    `tensors` (the pack, counters, chunk sums), the step functions by loss
    phase (`steps`) and the graphs' one memory pool."""

    def __init__(self, params, optimizer, generator: torch.Generator,
                 tensors: Dict[str, torch.Tensor]):
        self.params = params
        self.optimizer = optimizer
        self.generator = generator
        self.tensors = tensors
        self.steps: Dict[object, "CapturedStep"] = {}
        self.pool = None
        self.device = _leaves(params)[0].device

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


class FitGraphs:
    """The CUDA graphs of stage-1 fits and pretrains on one process (see
    the module docstring).  `keep=False`: the graphs of one fit.
    `keep=True`: states kept by the fit's shape across fits, at most
    `MAX_STATES` of them.  `eager=True` captures
    nothing (the eager fit that the card's tests and chip_smoke compare the
    captured one with).  `captured` counts the graphs captured."""

    def __init__(self, keep: bool = False, eager: bool = False):
        self.keep = keep
        self.eager = eager
        self.states: "OrderedDict[tuple, FitState]" = OrderedDict()
        self.captured = 0
        self._streams: Dict[torch.device, object] = {}

    # -- when to capture --------------------------------------------------
    def uncaptured(self, device: torch.device,
                   sharded: bool = False) -> Optional[str]:
        """Why a fit on `device` cannot be captured; None when it can."""
        if device.type != "cuda":
            return "the CPU has no CUDA graphs"
        if torch.is_anomaly_enabled():
            return ("autograd's anomaly mode (DEFLICKER_DEBUG_NANS) syncs at "
                    "every node of the backward")
        if sharded:
            return ("the sample-sharded fit all-reduces its gradients in "
                    "every step")
        return None

    def capturing(self, device: torch.device, what: str,
                  sharded: bool = False) -> bool:
        """Whether `what` (a fit, a pretrain) is captured.  An uncaptured
        run says so and why on one line."""
        reason = ("the caller asked for it" if self.eager
                  else self.uncaptured(device, sharded))
        if reason is not None:
            print(f"[deflicker_torch] {what} steps run uncaptured: {reason}",
                  flush=True)
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
            return st
        mine = _clone_tree(params)
        gen = torch.Generator(device=generator.device)
        gen.set_state(generator.get_state())
        st = FitState(mine, make_optimizer(mine), gen,
                      {name: t.clone() for name, t in tensors.items()})
        self.states[key] = st
        while len(self.states) > MAX_STATES:
            self.states.popitem(last=False)
        return st

    # -- the CUDA side (a CPU test replaces these three) -----------------
    def _stream(self, device: torch.device):
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def warm_up(self, state: FitState, fn: Callable) -> None:
        """One eager step on the capture stream."""
        with torch.cuda.device(state.device):
            stream = self._stream(state.device)
            main = torch.cuda.current_stream()
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                fn()
            main.wait_stream(stream)

    def _record(self, state: FitState, fn: Callable):
        """Capture `fn` into a graph drawing from the state's generator, in
        the state's memory pool."""
        with torch.cuda.device(state.device):
            if state.pool is None:
                state.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(state.generator)
            with torch.cuda.graph(graph, pool=state.pool,
                                  stream=self._stream(state.device)):
                fn()
        return graph

    def replay(self, state: FitState, graph, n: int) -> None:
        with torch.cuda.device(state.device):
            for _ in range(n):
                graph.replay()

    def capture(self, state: FitState, fn: Callable
                ) -> Tuple[object, List[Tuple[dict, dict]]]:
        """(graph, per-counter launches of one step).  The launches the
        wrappers counted while capturing are taken back: capture launches
        nothing."""
        before = [dict(c) for c in COUNTERS]
        graph = self._record(state, fn)
        counts = []
        for c, b in zip(COUNTERS, before):
            delta = {k: c[k] - b[k] for k in c if c[k] != b[k]}
            for k, v in delta.items():
                c[k] -= v
            counts.append((c, delta))
        self.captured += 1
        return graph, counts


class CapturedStep:
    """A step function run n steps at a time (see the module docstring).
    `run` takes the `FitGraphs` and the `FitState` whose `steps` hold this
    one rather than keeping them, so that no reference cycle outlives a
    fit: with `graphs` None the steps run eagerly, else warm-up steps, one
    capture, then replays, in the state's graphs."""

    def __init__(self, step: Callable):
        self.step = step
        self.graph = None
        self.warm = 0
        self.counts: List[Tuple[dict, dict]] = []

    def run(self, g: Optional[FitGraphs], state: FitState, n: int) -> None:
        if g is None:
            for _ in range(n):
                self.step()
            return
        while n > 0 and self.graph is None:
            if self.warm < WARMUP_STEPS:
                g.warm_up(state, self.step)
                self.warm += 1
                n -= 1
            else:
                self.graph, self.counts = g.capture(state, self.step)
        if n > 0:
            g.replay(state, self.graph, n)
            for counters, delta in self.counts:
                for k, v in delta.items():
                    counters[k] += v * n
