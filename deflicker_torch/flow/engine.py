"""Flow engine: batched RAFT pairs + the `.npy` flow cache contract.

The reference's flow preprocessing (src/preprocess_optical_flow.py +
src/models/stage_1/raft_wrapper.py), as the JAX package runs it:

  * forward and backward flow of several frame pairs run as ONE batch
    through RAFT (the reference makes two sequential calls per pair);
  * `<vid>_flow/<fn1>_<fn2>.npy` float32 HxWx2 per direction, idempotent
    (existing files are skipped);
  * the weightless `FarnebackFlow` provider (cv2, on the host) keeps the
    pipeline runnable when no RAFT checkpoint is on disk.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import List, Optional, Protocol, Tuple

import numpy as np
import torch

from ..io.media import FlowCache, list_frames
from ..ops.pad import Padder
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


class RAFTFlow:
    """RAFT-based provider (the reference's RAFTWrapper role) on `device`
    (CUDA unless the caller names another; raises without CUDA)."""

    def __init__(self, checkpoint: Optional[str | Path] = None,
                 model=None, iters: int = 20, dtype=torch.bfloat16,
                 device=None, corr_mode: str = "auto"):
        from .convert import load_raft_checkpoint

        self.device = resolve_device(device)
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

    def compute_batch(self, im1: np.ndarray, im2: np.ndarray) -> np.ndarray:
        """Flow for a batch of pairs: (B, H, W, 3) x2 in [0,255] -> (B, H, W, 2)."""
        from ..models.raft import raft_flow

        _, H, W, _ = im1.shape
        if self.dtype == torch.bfloat16:
            # frames originate as uint8 PNGs and the INTER_AREA-resize
            # fractional parts are below bf16 conv noise: uploading uint8
            # quarters the host-to-device bytes
            im1 = np.clip(np.round(im1), 0, 255).astype(np.uint8)
            im2 = np.clip(np.round(im2), 0, 255).astype(np.uint8)
        padder = Padder(H, W, divisor=8, mode="sintel")
        # edge replication is exact in any dtype; pad as float, since
        # replicate padding takes no integer tensors
        x1 = padder.pad(torch.from_numpy(im1).to(self.device).float())
        x2 = padder.pad(torch.from_numpy(im2).to(self.device).float())
        _, flow_up = raft_flow(self.model, x1, x2, iters=self.iters,
                               dtype=self.dtype, corr_mode=self.corr_mode)
        return padder.unpad(flow_up).cpu().numpy()

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
                            pair_batch: int = 4) -> List[Path]:
    """Compute+cache flow for all adjacent pairs of `frames_dir`.

    Mirrors `preprocess(args)` (src/preprocess_optical_flow.py:10-48):
    idempotent per pair, long-edge-capped inputs, fwd+bwd `.npy` outputs.
    Returns the list of written/reused forward-flow paths.

    Uncached pairs run through a provider with `compute_batch` in batches
    of `pair_batch` pairs x 2 directions per call; a provider without it
    (Farneback) runs pair by pair.
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
        cache.save_pair(files[k].name, files[k + 1].name, f12, f21)
        if verbose:
            print(f"flow {files[k].name} <-> {files[k + 1].name}")

    if not (hasattr(provider, "compute_batch") and pair_batch > 1):
        for k in missing:
            im1 = load_flow_image(files[k], max_long_edge)
            im2 = load_flow_image(files[k + 1], max_long_edge)
            save(k, *provider.compute_pair(im1, im2))
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
    return out
