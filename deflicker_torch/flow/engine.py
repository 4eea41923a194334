"""Flow engine: batched RAFT pairs + the `.npy` flow cache contract.

The reference's flow preprocessing (src/preprocess_optical_flow.py +
src/models/stage_1/raft_wrapper.py), as the JAX package runs it:

  * forward and backward flow of several frame pairs run as ONE batch
    through RAFT (the reference makes two sequential calls per pair);
  * `<vid>_flow/<fn1>_<fn2>.npy` float32 HxWx2 per direction, idempotent
    (existing files are skipped);
  * the weightless `FarnebackFlow` provider (cv2, on the host) keeps the
    pipeline runnable when no RAFT checkpoint is on disk;
  * with a mesh (parallel/mesh.py) each batch of pairs splits over the
    ranks and is gathered (the JAX package pads the batch to a multiple of
    the devices; here a rank's block may be one pair shorter), and only
    rank 0 writes the cache;
  * on the card a solve is one CUDA graph (atlas/graphs.py), the
    counterpart of the JAX package's one jitted `raft_flow` program: the
    normalisation, fnet, cnet, the pyramid, the GRU iterations and the
    upsample, from static padded images to a static `flow_up`, replayed
    once a batch of a shape already solved;
  * on the card a batch's frames reach the device, and its flows come
    back, through pinned host memory (`_Staging`, `RAFTFlow._download`),
    which the DMA engines read and write at the link's rate; pageable
    memory goes through the CUDA runtime's own small bounce buffers a
    chunk at a time, with the host thread blocked and the card idle.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import List, Optional, Protocol, Tuple

import numpy as np
import torch

from ..io.media import FlowCache, list_frames
from ..ops.pad import Padder
from ..parallel.mesh import (Mesh, barrier, batch_sharding, is_main,
                             shard_constraint)
from ..utils import trace
from ..utils.device import resolve_device


class FlowProvider(Protocol):
    def compute_pair(self, im1: np.ndarray, im2: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(flow 1->2, flow 2->1), each (H, W, 2) float32."""
        ...


def load_flow_image(path: str | Path, max_long_edge: int = 2000) -> np.ndarray:
    """Read a frame as float32 RGB in [0, 255], INTER_AREA-downscaled so the
    long edge is <= max_long_edge (reference: raft_wrapper.py:31-46)."""
    import cv2
    from PIL import Image

    img = np.array(Image.open(str(path)).convert("RGB")).astype(np.float32)
    h, w = img.shape[:2]
    long_edge = max(h, w)
    if long_edge > max_long_edge:
        scale = max_long_edge / long_edge
        img = cv2.resize(img, (int(round(w * scale)), int(round(h * scale))),
                         interpolation=cv2.INTER_AREA)
    return img


# pinned slots a batch's frames pass through on their way to the card, one
# array a slot: the host fills one while the card reads the other
SLOTS = 2


class _Staging:
    """Pinned host slots that host arrays pass through on their way to one
    card, taken in turn.  A slot is written again only once the copy that
    last read it has run on the card (its event), and grows when an array
    needs more bytes than it holds; each slot made or grown counts
    `flow.staging_made`.  An array goes in one piece: split into chunks,
    the card reading one while the host fills the next, it was slower on
    an H100's 8-core host, where every parallel host copy risks a stall."""

    def __init__(self, device: torch.device):
        self.device = device
        self.slots: List[Optional[torch.Tensor]] = [None] * SLOTS
        self.read = [torch.cuda.Event() for _ in range(SLOTS)]
        self.next = 0

    def to_device(self, src: torch.Tensor) -> torch.Tensor:
        """A copy of `src` (on the host) on the card, issued on the current
        stream; returns once it is issued."""
        k = self.next
        self.next = (k + 1) % SLOTS
        nbytes = src.numel() * src.element_size()
        self.read[k].synchronize()      # returns at once if never recorded
        if self.slots[k] is None or self.slots[k].numel() < nbytes:
            self.slots[k] = torch.empty((nbytes,), dtype=torch.uint8,
                                        pin_memory=True)
            trace.count("flow.staging_made")
        pinned = self.slots[k][:nbytes].view(src.dtype).view(src.shape)
        pinned.copy_(src)
        dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        dst.copy_(pinned, non_blocking=True)
        self.read[k].record(torch.cuda.current_stream(self.device))
        return dst


class _Solve:
    """A captured solve's static buffers: the padded images it reads and
    the `flow_up` it writes."""

    def __init__(self, model, B, Hp, Wp, iters, dtype, corr_mode, device):
        from ..atlas.graphs import WARMUP_CALLS, CapturedStep
        from ..models.raft import raft_flow

        x1, x2 = (torch.empty((B, Hp, Wp, 3), device=device)
                  for _ in range(2))
        out = torch.empty((B, Hp, Wp, 2), device=device)

        def solve():
            out.copy_(raft_flow(model, x1, x2, iters=iters, dtype=dtype,
                                corr_mode=corr_mode)[1])

        self.x1, self.x2, self.out = x1, x2, out
        self.step = CapturedStep(solve, WARMUP_CALLS)


class RAFTFlow:
    """RAFT-based provider (the reference's RAFTWrapper role) on `device`
    (CUDA unless the caller names another; raises without CUDA).  With
    `mesh` (on its rank's device) every rank calls `compute_batch` with the
    same pairs, solves its block of them and gets them all back.

    On the card each solve is a CUDA graph (`graphs`, an
    `InferenceGraphs`), keyed by what it bakes in: the batch, the padded
    size, dtype, iterations, the correlation mode and body.  A key's first
    batch is solved eagerly and the key is captured right after it, so a
    shape seen once (a run's tail batch) costs one capture it never
    replays.  `capture=False` solves eagerly on the card (the comparison
    the card's tests and chip_smoke make)."""

    def __init__(self, checkpoint: Optional[str | Path] = None,
                 model=None, iters: int = 20, dtype=torch.bfloat16,
                 device=None, corr_mode: str = "auto",
                 mesh: Optional[Mesh] = None,
                 capture: Optional[bool] = None):
        from ..atlas.graphs import InferenceGraphs
        from .convert import load_raft_checkpoint

        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        if model is None:
            if checkpoint is None:
                raise ValueError("RAFTFlow needs a checkpoint or a model")
            model = load_raft_checkpoint(checkpoint)
        else:
            model = copy.deepcopy(model)     # .to() below converts in place
        # bfloat16 convs/GRU = the reference's autocast mixed precision
        # (raft_wrapper.py:19); flow math stays f32 inside raft_flow
        self.model = model.to(device=self.device, dtype=dtype)
        self.iters = iters
        self.dtype = dtype
        self.corr_mode = corr_mode
        self.graphs = InferenceGraphs(self.device, "RAFT solves", capture)
        self._said_empty = False
        self._staging = (_Staging(self.device) if self.device.type == "cuda"
                         else None)

    def _solve(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """flow_up of padded images on the device: `raft_flow`, or its
        captured solve."""
        from ..models.raft import _select_corr_mode, raft_flow
        from ..ops.cuda.corr_kernel import select_body

        if not self.graphs.enabled:
            return raft_flow(self.model, x1, x2, iters=self.iters,
                             dtype=self.dtype, corr_mode=self.corr_mode)[1]
        B, Hp, Wp, _ = x1.shape
        mode = _select_corr_mode(self.corr_mode, self.device, B,
                                 (Hp // 8) * (Wp // 8))
        # the body is read once a solve: a switch selects another graph
        body = select_body() if mode == "kernel" else None
        key = (B, Hp, Wp, self.dtype, self.iters, mode, body)
        e = self.graphs.entry(key, lambda: _Solve(
            self.model, B, Hp, Wp, self.iters, self.dtype, mode, self.device))
        e.x1.copy_(x1)
        e.x2.copy_(x2)
        self.graphs.run(e.step)
        return e.out

    def _upload(self, im: torch.Tensor) -> torch.Tensor:
        """Frames onto the device as float, on the card through the pinned
        staging.  In bf16 they are rounded to whole levels in [0, 255]:
        they originate as uint8 PNGs, and the INTER_AREA-resize fractional
        parts are below bf16 conv noise.  The rounding runs on the device,
        where it costs less than numpy's passes over the batch on the
        host."""
        if self._staging is None:
            x = im.to(self.device)      # on the CPU: the caller's array
        else:
            x = self._staging.to_device(im)
        x = x.float()
        if self.dtype == torch.bfloat16:
            x = x.round().clamp_(0, 255)
        return x

    def _download(self, flow: torch.Tensor) -> np.ndarray:
        """The flows as a numpy array on the host.  On the card they come
        back into a pinned block of the caching host allocator, which
        hands the block out again only after the array is dropped."""
        if self._staging is None:
            return flow.cpu().numpy()
        out = torch.empty(flow.shape, dtype=flow.dtype, pin_memory=True)
        out.copy_(flow, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return out.numpy()

    def compute_batch(self, im1: np.ndarray, im2: np.ndarray) -> np.ndarray:
        """Flow for a batch of pairs: (B, H, W, 3) x2 in [0,255] -> (B, H, W, 2).

        Its spans (`utils/trace.py`): `flow/batch` around `flow/upload`
        (the arrays wrapped, copied to the device, cast, rounded and
        padded; on the card the host's copies into the pinned staging and
        the copies to the device issued), `flow/solve` (the copy into the
        captured solve's buffers and its replay, or the eager solve),
        `flow/wait` (only while spans record: the stream synchronised,
        which the copy back would wait for anyway, so that the download's
        span holds only the copy; the copy is then issued after the solve
        ends instead of during it, which leaves the card idle a little
        longer in a traced batch) and `flow/download` (unpad, the gather
        across ranks, the copy back)."""
        with trace.span("flow/batch"):
            B, H, W, _ = im1.shape
            padder = Padder(H, W, divisor=8, mode="sintel")
            with trace.span("flow/upload"):
                im1 = batch_sharding(torch.from_numpy(im1), self.mesh)
                im2 = batch_sharding(torch.from_numpy(im2), self.mesh)
                if im1.shape[0]:
                    x1, x2 = (padder.pad(self._upload(im))
                              for im in (im1, im2))
            if im1.shape[0]:
                with trace.span("flow/solve"):
                    flow = self._solve(x1, x2)
            else:           # more ranks than pairs: this rank solves none
                if not self._said_empty:
                    from ..atlas.graphs import say_uncaptured

                    say_uncaptured("RAFT solves",
                                   "this rank's block of pairs is empty")
                    self._said_empty = True
                flow = torch.zeros((0, *padder.padded_hw, 2),
                                   device=self.device)
            if trace.enabled():
                with trace.span("flow/wait"):
                    if self.device.type == "cuda":
                        torch.cuda.current_stream(self.device).synchronize()
            with trace.span("flow/download"):
                return self._download(shard_constraint(
                    padder.unpad(flow), self.mesh, 0, B))

    def compute_pair(self, im1: np.ndarray, im2: np.ndarray):
        both = self.compute_batch(np.stack([im1, im2]), np.stack([im2, im1]))
        return both[0], both[1]


class FarnebackFlow:
    """cv2 Farneback dense flow — weightless host-side fallback with the same
    interface (not in the reference; quality is below RAFT, use for smoke
    runs and bootstrapping without checkpoints)."""

    def __init__(self, **kwargs):
        self.params = dict(pyr_scale=0.5, levels=5, winsize=21, iterations=3,
                           poly_n=7, poly_sigma=1.5, flags=0)
        self.params.update(kwargs)

    def _one(self, a, b):
        import cv2

        g1 = cv2.cvtColor(a.astype(np.uint8), cv2.COLOR_RGB2GRAY)
        g2 = cv2.cvtColor(b.astype(np.uint8), cv2.COLOR_RGB2GRAY)
        return cv2.calcOpticalFlowFarneback(g1, g2, None,
                                            **self.params).astype(np.float32)

    def compute_pair(self, im1, im2):
        return self._one(im1, im2), self._one(im2, im1)


def preprocess_optical_flow(frames_dir: str | Path, provider: FlowProvider,
                            max_long_edge: int = 2000,
                            verbose: bool = True,
                            pair_batch: int = 4,
                            mesh: Optional[Mesh] = None) -> List[Path]:
    """Compute+cache flow for all adjacent pairs of `frames_dir`.

    Mirrors `preprocess(args)` (src/preprocess_optical_flow.py:10-48):
    idempotent per pair, long-edge-capped inputs, fwd+bwd `.npy` outputs.
    Returns the list of written/reused forward-flow paths.

    Uncached pairs run through a provider with `compute_batch` in batches
    of `pair_batch` pairs x 2 directions per call; a provider without it
    (Farneback) runs pair by pair.

    With `mesh` every rank calls it: rank 0 writes the cache (and alone runs
    a provider without `compute_batch`), the ranks solve each batch
    together through a provider on the mesh, and all return once the
    files are on disk.
    """
    frames_dir = Path(frames_dir)
    files = list_frames(frames_dir)
    cache = FlowCache(frames_dir)
    out: List[Path] = []
    missing: List[int] = []
    for k in range(len(files) - 1):
        fn1, fn2 = files[k].name, files[k + 1].name
        out.append(cache.pair_paths(fn1, fn2)[0])
        if not cache.has_pair(fn1, fn2):
            missing.append(k)

    def save(k, f12, f21):
        if not is_main(mesh):
            return
        cache.save_pair(files[k].name, files[k + 1].name, f12, f21)
        if verbose:
            print(f"flow {files[k].name} <-> {files[k + 1].name}")

    if not (hasattr(provider, "compute_batch") and pair_batch > 1):
        for k in missing if is_main(mesh) else ():
            im1 = load_flow_image(files[k], max_long_edge)
            im2 = load_flow_image(files[k + 1], max_long_edge)
            save(k, *provider.compute_pair(im1, im2))
        barrier(mesh)
        return out

    for s in range(0, len(missing), pair_batch):
        ks = missing[s:s + pair_batch]
        ims = {idx: load_flow_image(files[idx], max_long_edge)
               for idx in sorted({i for k in ks for i in (k, k + 1)})}
        # forward and backward directions of every pair in one batch
        a = np.stack([ims[k] for k in ks] + [ims[k + 1] for k in ks])
        b = np.stack([ims[k + 1] for k in ks] + [ims[k] for k in ks])
        flows = provider.compute_batch(a, b)
        n = len(ks)
        for idx, k in enumerate(ks):
            save(k, flows[idx], flows[n + idx])
    barrier(mesh)
    return out
