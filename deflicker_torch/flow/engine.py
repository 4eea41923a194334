"""Flow engine: the `.npy` flow cache contract and the Farneback provider.

The reference's flow preprocessing (src/preprocess_optical_flow.py):
`<vid>_flow/<fn1>_<fn2>.npy` float32 HxWx2 per direction, idempotent
(existing files are skipped).  The weightless `FarnebackFlow` provider (cv2,
on the host) runs when no RAFT checkpoint is on disk — the default here.
RAFT and its correlation kernel are the next slice of the port; until then
the pipeline refuses a RAFT checkpoint rather than compute other flow than
the JAX package would (cli/pipeline.make_flow_provider).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Protocol, Tuple

import numpy as np

from ..io.media import FlowCache, list_frames


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
                            verbose: bool = True) -> List[Path]:
    """Compute+cache flow for all adjacent pairs of `frames_dir`.

    Mirrors `preprocess(args)` (src/preprocess_optical_flow.py:10-48):
    idempotent per pair, long-edge-capped inputs, fwd+bwd `.npy` outputs.
    Returns the list of written/reused forward-flow paths.
    """
    frames_dir = Path(frames_dir)
    files = list_frames(frames_dir)
    cache = FlowCache(frames_dir)
    out: List[Path] = []
    for k in range(len(files) - 1):
        fn1, fn2 = files[k].name, files[k + 1].name
        out.append(cache.pair_paths(fn1, fn2)[0])
        if cache.has_pair(fn1, fn2):
            continue
        im1 = load_flow_image(files[k], max_long_edge)
        im2 = load_flow_image(files[k + 1], max_long_edge)
        f12, f21 = provider.compute_pair(im1, im2)
        cache.save_pair(fn1, fn2, f12, f21)
        if verbose:
            print(f"flow {fn1} <-> {fn2}")
    return out
