"""Optical-flow file I/O and visualization.

Covers the reference's flow-format utilities
(src/models/stage_1/core/utils/frame_utils.py:12-136 — Middlebury `.flo`,
KITTI 16-bit PNG — and flow_viz.py:20-131 — Middlebury color wheel), which
its RAFT wrapper uses for visualization, plus the `.npy` cache format the
pipeline itself exchanges.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_FLO_MAGIC = 202021.25  # Middlebury sanity-check sentinel


def read_flo(path: str | Path) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(_FLO_MAGIC):
            raise ValueError(f"not a .flo file: {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str | Path, flow: np.ndarray) -> None:
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([_FLO_MAGIC], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_kitti_flow(path: str | Path):
    """KITTI 16-bit PNG -> ((H, W, 2) flow, (H, W) validity)."""
    import cv2

    raw = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    raw = raw[:, :, ::-1].astype(np.float32)   # BGR -> RGB channel order
    flow = (raw[:, :, :2] - 2 ** 15) / 64.0
    valid = raw[:, :, 2] > 0.5
    return flow, valid


def write_kitti_flow(path: str | Path, flow: np.ndarray,
                     valid: np.ndarray | None = None) -> None:
    import cv2

    h, w = flow.shape[:2]
    if valid is None:
        valid = np.ones((h, w), np.float32)
    enc = np.zeros((h, w, 3), np.uint16)
    enc[:, :, 0] = np.clip(flow[:, :, 0] * 64.0 + 2 ** 15, 0, 65535)
    enc[:, :, 1] = np.clip(flow[:, :, 1] * 64.0 + 2 ** 15, 0, 65535)
    enc[:, :, 2] = (valid > 0.5).astype(np.uint16)
    cv2.imwrite(str(path), enc[:, :, ::-1])


def read_pfm(path: str | Path):
    """PFM image -> (array, scale); float32, rows flipped to top-down
    (frame_utils.py readPFM role)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"not a PFM file: {path}")
        w, h = map(int, f.readline().split())
        scale = float(f.readline().strip())
        big_endian = scale > 0
        data = np.fromfile(f, ">f" if big_endian else "<f", h * w * channels)
    img = data.reshape(h, w, channels) if channels > 1 else data.reshape(h, w)
    return np.flipud(img).astype(np.float32), abs(scale)


def write_pfm(path: str | Path, img: np.ndarray, scale: float = 1.0) -> None:
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[2] == 3:
        header = b"PF"
    elif img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 1):
        header = b"Pf"
    else:
        raise ValueError(f"unsupported PFM shape: {img.shape}")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(f"{-scale}\n".encode())        # little-endian
        np.flipud(img).astype("<f").tofile(f)


def _color_wheel() -> np.ndarray:
    """The standard 55-color Middlebury wheel (RY/YG/GC/CB/BM/MR arcs)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    ramps = [
        (RY, 0, 1, +1),   # red -> yellow: G ramps up
        (YG, 1, 0, -1),   # yellow -> green: R ramps down
        (GC, 1, 2, +1),   # green -> cyan: B ramps up
        (CB, 2, 1, -1),   # cyan -> blue: G ramps down
        (BM, 2, 0, +1),   # blue -> magenta: R ramps up
        (MR, 0, 2, -1),   # magenta -> red: B ramps down
    ]
    for n, base, ramp, sign in ramps:
        wheel[col:col + n, base] = 1.0
        r = np.arange(n) / n
        wheel[col:col + n, ramp] = r if sign > 0 else 1.0 - r
        col += n
    return wheel


def flow_to_image(flow: np.ndarray, clip_flow: float | None = None,
                  normalize: bool = True) -> np.ndarray:
    """Flow (H, W, 2) -> uint8 RGB via the Middlebury color wheel
    (hue = direction, saturation = magnitude), the same convention as the
    reference's flow_viz (core/utils/flow_viz.py:20-131)."""
    flow = np.asarray(flow, np.float32)
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    if clip_flow is not None:
        u = np.clip(u, -clip_flow, clip_flow)
        v = np.clip(v, -clip_flow, clip_flow)
    if normalize:
        rad_max = np.sqrt(u ** 2 + v ** 2).max()
        scale = max(rad_max, 1e-5)
        u, v = u / scale, v / scale

    wheel = _color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    angle = np.arctan2(-v, -u) / np.pi           # (-1, 1]
    fk = (angle + 1.0) / 2.0 * (ncols - 1)       # wheel position
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(u.shape + (3,), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c]
        col1 = wheel[k1, c]
        col = (1.0 - f) * col0 + f * col1
        # desaturate toward white with decreasing magnitude inside the
        # unit disk; darken outside it
        inside = rad <= 1.0
        col = np.where(inside, 1.0 - rad * (1.0 - col), col * 0.75)
        img[..., c] = np.floor(255.0 * col)
    return img
