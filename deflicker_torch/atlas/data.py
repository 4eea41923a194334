"""Stage-1 input loading: frames, derivatives, flow, consistency masks.

Host-side analog of the reference's `load_input_data[_single]`
(src/models/stage_1/unwrap_utils.py:40-163) producing (T, H, W, C) numpy
arrays, as the JAX package does.  The filesystem contract is identical:
frames in `<root>/<vid>`, flow in `<root>/<vid>_flow/<fn1>_<fn2>.npy`,
masks in `<root>/<vid>_seg` (dual-atlas path).

Flow layout: flows_fwd[f] maps frame f -> f+1 (zero at f=T-1), flows_bwd[f]
maps frame f -> f-1 (zero at f=0), so a sample at frame f always gathers its
own frame's entry.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..io.media import imresize, list_frames, read_image
from ..ops.consistency import resize_flow


class VideoData(NamedTuple):
    """Everything the fit needs. Host numpy arrays shaped (T, H, W, .); only
    `packed` lives on the device."""

    video: np.ndarray        # (T, H, W, 3) float32 in [0, 1]
    dx: np.ndarray           # (T, H, W, 3) horizontal one-sided derivative
    dy: np.ndarray           # (T, H, W, 3) vertical one-sided derivative
    mask: np.ndarray         # (T, H, W) segmentation mask in [0, 1]
    flow_fwd: np.ndarray     # (T, H, W, 2) flow f -> f+1 (0 at last frame)
    flow_bwd: np.ndarray     # (T, H, W, 2) flow f -> f-1 (0 at first frame)
    mask_fwd: np.ndarray     # (T, H, W) consistency mask for flow_fwd
    mask_bwd: np.ndarray     # (T, H, W) consistency mask for flow_bwd
    packed: Optional[torch.Tensor] = None   # (T, H, W, 16) fit gather pack

    def with_packed(self, device="cpu") -> "VideoData":
        """Channel-pack every per-pixel fit input into one (T, H, W, 16)
        tensor on `device`, so a sampled batch is ONE row gather instead of
        seven.  Channel layout: [rgb 0:3 | dx 3:6 | dy 6:9 | flow_fwd 9:11 |
        flow_bwd 11:13 | mask_fwd 13 | mask_bwd 14 | mask 15].  The pack is
        the only fit tensor kept on the device; the other fields stay on the
        host for evaluation."""
        if self.packed is not None and self.packed.device == torch.device(device):
            return self
        p = np.concatenate([
            np.asarray(self.video), np.asarray(self.dx), np.asarray(self.dy),
            np.asarray(self.flow_fwd), np.asarray(self.flow_bwd),
            np.asarray(self.mask_fwd)[..., None].astype(np.float32),
            np.asarray(self.mask_bwd)[..., None].astype(np.float32),
            np.asarray(self.mask)[..., None].astype(np.float32)], axis=-1)
        return self._replace(packed=torch.from_numpy(p).to(device))

    @property
    def num_frames(self) -> int:
        return self.video.shape[0]

    @property
    def res(self):
        return self.video.shape[1], self.video.shape[2]

    @property
    def larger_dim(self) -> int:
        return max(self.video.shape[1], self.video.shape[2])


def _consistency_np(flow12: np.ndarray, flow21: np.ndarray) -> np.ndarray:
    """Host-side fwd-bwd consistency (cv2.remap recipe, unwrap_utils.py:10-30)."""
    import cv2

    h, w = flow12.shape[:2]
    grid = flow12.copy()
    grid[:, :, 0] += np.arange(w)
    grid[:, :, 1] += np.arange(h)[:, None]
    warped21 = cv2.remap(flow21, grid, None, cv2.INTER_LINEAR)
    diff = flow12 + warped21
    return np.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2) < 1.0


def load_video_data(frames_dir: str | Path, resy: int, resx: int,
                    maximum_number_of_frames: int = 200,
                    use_masks: bool = False,
                    mask_dir_suffix: str = "_seg",
                    filter_optical_flow: bool = True,
                    flow_dir: Optional[str | Path] = None,
                    start_frame: int = 0) -> VideoData:
    """Load frames + flow cache into a VideoData of host arrays.

    `start_frame` selects a chunk of a longer video (the chunked long-video
    path, cli/pipeline._run_stage1_chunked): frames `[start_frame,
    start_frame + maximum_number_of_frames)` load with the chunk edges treated exactly
    like video edges (zero flow/mask on the first/last frame's missing
    side) — the same semantics the reference prescribes for manually split
    long videos (README.md:117)."""
    import cv2

    frames_dir = Path(frames_dir)
    vid_name = frames_dir.name
    vid_root = frames_dir.parent
    flow_dir = Path(flow_dir) if flow_dir else vid_root / f"{vid_name}_flow"
    mask_dir = vid_root / f"{vid_name}{mask_dir_suffix}"

    files = list_frames(frames_dir)[start_frame:]
    T = min(maximum_number_of_frames, len(files))
    if T == 0:
        raise FileNotFoundError(f"no frames in {frames_dir}")

    video = np.zeros((T, resy, resx, 3), np.float32)
    mask = np.zeros((T, resy, resx), np.float32)
    mask_files = list_frames(mask_dir)[start_frame:] if use_masks else []

    for t in range(T):
        im = read_image(files[t])
        video[t] = imresize(im, resx, resy)
        if use_masks:
            from PIL import Image

            m = np.array(Image.open(str(mask_files[t]))).astype(np.float32) / 255.0
            if m.ndim == 3:
                m = m[..., 0]
            # NB: the reference passes INTER_NEAREST positionally into
            # cv2.resize's `dst` slot (unwrap_utils.py:69), so the actual
            # interpolation used is the default INTER_LINEAR; we match that.
            mask[t] = cv2.resize(m, (resx, resy), interpolation=cv2.INTER_LINEAR)

    # one-sided forward differences, zero on the last row/col
    dx = np.zeros_like(video)
    dy = np.zeros_like(video)
    dx[:, :, :-1] = video[:, :, 1:] - video[:, :, :-1]
    dy[:, :-1, :] = video[:, 1:] - video[:, :-1]

    flow_fwd = np.zeros((T, resy, resx, 2), np.float32)
    flow_bwd = np.zeros((T, resy, resx, 2), np.float32)
    mask_fwd = np.zeros((T, resy, resx), np.float32)
    mask_bwd = np.zeros((T, resy, resx), np.float32)

    for t in range(T - 1):
        fn1, fn2 = files[t].name, files[t + 1].name
        f12 = np.load(flow_dir / f"{fn1}_{fn2}.npy").astype(np.float32)
        f21 = np.load(flow_dir / f"{fn2}_{fn1}.npy").astype(np.float32)
        if f12.shape[0] != resy or f12.shape[1] != resx:
            f12 = resize_flow(f12, resy, resx)
            f21 = resize_flow(f21, resy, resx)
        flow_fwd[t] = f12
        flow_bwd[t + 1] = f21
        if filter_optical_flow:
            mask_fwd[t] = _consistency_np(f12, f21)
            mask_bwd[t + 1] = _consistency_np(f21, f12)
        else:
            mask_fwd[t] = 1.0
            mask_bwd[t + 1] = 1.0

    # leaves stay on the host: the fit uploads only the gather pack
    # (with_packed), evaluation reads these on the host
    return VideoData(video, dx, dy, mask,
                     flow_fwd, flow_bwd, mask_fwd, mask_bwd)
