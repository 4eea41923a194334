"""Host-side media I/O.

Keeps the reference's filesystem contract exactly (SURVEY.md §1):
  frames:   data/test/<vid>/%05d.png        (start number 0)
  flow:     data/test/<vid>_flow/<fn1>_<fn2>.npy  (float32 HxWx2)
  masks:    data/test/<vid>_seg/%05d.png
  outputs:  results/<vid>/stage_1/output/%05d.png,
            results/<vid>/{neural_filter/{concat,output},final/output}/%05d.png + .mp4

Video decode/encode uses the ffmpeg binary when present (same commands as
reference test.py:22 / neural_filter_and_refinement.py:125-130) and falls
back to OpenCV's bundled codecs otherwise.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path
from typing import List

import cv2
import numpy as np


def _has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def video_to_frames(video_path: str | Path, out_dir: str | Path, fps: int = 10) -> List[Path]:
    """Decode `video_path` to `out_dir`/%05d.png at `fps` (start number 0).

    Mirrors `ffmpeg -i X -vf fps=F -start_number 0 out/%05d.png`
    (reference: test.py:22).
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    video_path = str(video_path)

    if _has_ffmpeg():
        cmd = ["ffmpeg", "-y", "-i", video_path, "-vf", f"fps={fps}",
               "-start_number", "0", str(out_dir / "%05d.png")]
        subprocess.run(cmd, check=True, capture_output=True)
        return sorted(out_dir.glob("*.png"))

    # cv2 fallback: resample by timestamp like ffmpeg's fps filter
    # (each output tick t_k = k/fps shows the last source frame with
    # pts <= t_k).
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video: {video_path}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or float(fps)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    if not frames:
        raise RuntimeError(f"no frames decoded from {video_path}")

    duration = len(frames) / src_fps
    n_out = max(1, int(round(duration * fps)))
    written = []
    for k in range(n_out):
        t = k / fps
        src_idx = min(int(np.floor(t * src_fps + 1e-9)), len(frames) - 1)
        p = out_dir / f"{k:05d}.png"
        cv2.imwrite(str(p), frames[src_idx])
        written.append(p)
    return written


def frames_to_video(frames_dir: str | Path, out_path: str | Path,
                    fps: int = 10, pattern: str = "%05d.png") -> Path:
    """Encode `frames_dir`/pattern into an mp4 (reference:
    neural_filter_and_refinement.py:125-130)."""
    frames_dir = Path(frames_dir)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    if _has_ffmpeg():
        cmd = ["ffmpeg", "-y", "-r", str(fps), "-i",
               str(frames_dir / pattern), "-crf", "25", "-r", "12",
               "-qscale", "4", str(out_path)]
        subprocess.run(cmd, check=True, capture_output=True)
        return out_path

    files = sorted(frames_dir.glob("*.png"))
    if not files:
        raise RuntimeError(f"no frames in {frames_dir}")
    first = cv2.imread(str(files[0]))
    h, w = first.shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(str(out_path), fourcc, fps, (w, h))
    for f in files:
        writer.write(cv2.imread(str(f)))
    writer.release()
    return out_path


def list_frames(folder: str | Path) -> List[Path]:
    """Sorted frame files, same glob set as the reference loaders
    (*.jpg + *.png; src/models/stage_1/unwrap_utils.py:110)."""
    folder = Path(folder)
    return sorted(list(folder.glob("*.jpg")) + list(folder.glob("*.png")))


def read_image(path: str | Path, gray_to_rgb: bool = True) -> np.ndarray:
    """Read an image as float32 RGB in [0, 1], (H, W, 3)."""
    from PIL import Image

    img = np.array(Image.open(str(path))).astype(np.float32) / 255.0
    if img.ndim == 2 and gray_to_rgb:
        img = np.tile(img[:, :, None], (1, 1, 3))
    return img[..., :3]


def write_image(img: np.ndarray, path: str | Path) -> None:
    """Write float [0,1] RGB (or uint8) to PNG, no compression, like the
    reference's save_img (src/models/utils.py:234-247)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    bgr = img[:, :, ::-1] if img.ndim == 3 else img
    cv2.imwrite(str(path), bgr, [cv2.IMWRITE_PNG_COMPRESSION, 0])


def imresize(img: np.ndarray, w: int, h: int, interpolation=cv2.INTER_LINEAR) -> np.ndarray:
    return cv2.resize(img, (w, h), interpolation=interpolation)


class FlowCache:
    """The `.npy` flow cache contract: `<vid>_flow/<fn1>_<fn2>.npy`
    forward, `<fn2>_<fn1>.npy` backward (float32 HxWx2), idempotent —
    existing files are reused (reference: src/preprocess_optical_flow.py:23-32).
    """

    def __init__(self, frames_dir: str | Path):
        self.frames_dir = Path(frames_dir)
        self.flow_dir = self.frames_dir.parent / f"{self.frames_dir.name}_flow"

    def pair_paths(self, fn1: str, fn2: str):
        return (self.flow_dir / f"{fn1}_{fn2}.npy",
                self.flow_dir / f"{fn2}_{fn1}.npy")

    def has_pair(self, fn1: str, fn2: str) -> bool:
        p12, p21 = self.pair_paths(fn1, fn2)
        return p12.exists() and p21.exists()

    def save_pair(self, fn1: str, fn2: str, flow12: np.ndarray, flow21: np.ndarray):
        self.flow_dir.mkdir(exist_ok=True, parents=True)
        p12, p21 = self.pair_paths(fn1, fn2)
        np.save(p12, np.asarray(flow12, np.float32))
        np.save(p21, np.asarray(flow21, np.float32))

    def load_pair(self, fn1: str, fn2: str):
        p12, p21 = self.pair_paths(fn1, fn2)
        return np.load(p12), np.load(p21)
