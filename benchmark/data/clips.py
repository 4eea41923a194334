"""Procedural clips that know their own motion, made on the device from a seed.

Device-side copies of the two clip makers the on-card smoke script writes
as PNGs (`make_clip`: a panning texture; `make_dual_clip`: a textured disc
over a texture that pans at another speed, with its mask), frozen here so
that the benchmark's inputs never change with that script.  Both flicker:
every frame has its own global gain.  Frames are made at the frame size,
rounded down to whole levels as an 8-bit PNG would hold them, and averaged
down by `down` to the fit resolution, as the pipeline's `--down` does.

Because the generator moves every pixel itself, the flows are exact (no
flow estimator runs) and the consistency masks are the pixels whose match
lies inside the next (previous) frame and on the same layer.

Everything is a float32 tensor with a leading video axis:
video (V, T, h, w, 3) in [0, 1], flow_fwd / flow_bwd (V, T, h, w, 2) in
fit pixels (forward zero at the last frame, backward zero at the first),
mask_fwd / mask_bwd / mask (V, T, h, w).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..core.seeds import sub_seed


def _cubic_noise(gen, h, w, height, width, device):
    """Uniform(30, 220) noise on a coarse grid, bicubic to (height, width)."""
    small = torch.rand((1, 3, h, w), generator=gen, device=device) * 190 + 30
    return F.interpolate(small, size=(height, width), mode="bicubic",
                         align_corners=False)[0].permute(1, 2, 0)


def _gains(gen, T, device):
    return 1.0 + 0.15 * (torch.rand((T,), generator=gen, device=device) * 2 - 1)


def _finish(frames: torch.Tensor, down: int) -> torch.Tensor:
    """(T, H, W, 3) levels -> (T, H/down, W/down, 3) in [0, 1]."""
    frames = torch.floor(frames.clamp(0, 255))
    if down > 1:
        frames = F.avg_pool2d(frames.permute(0, 3, 1, 2), down).permute(0, 2, 3, 1)
    return (frames / 255.0).contiguous()


def _pan_clip(gen, T, H, W, down, device):
    """The panning texture: frame t shows columns [4t, 4t + W) of a wider
    texture, so every pixel moves 4 frame pixels left a frame."""
    Wb = W + 4 * T
    base = _cubic_noise(gen, H // 8, Wb // 8, H, Wb, device)
    yy = torch.arange(H, device=device, dtype=torch.float32)[:, None, None]
    xx = torch.arange(Wb, device=device, dtype=torch.float32)[None, :, None]
    base = base + 20.0 * torch.sin(xx / 9.0) * torch.cos(yy / 13.0)
    gains = _gains(gen, T, device)
    cols = 4 * torch.arange(T, device=device)[:, None] + torch.arange(W, device=device)
    frames = base[:, cols].permute(1, 0, 2, 3) * gains[:, None, None, None]
    h, w = H // down, W // down
    video = _finish(frames, down)
    step = 4.0 / down
    flow_fwd = torch.zeros((T, h, w, 2), device=device)
    flow_bwd = torch.zeros((T, h, w, 2), device=device)
    flow_fwd[:-1, ..., 0] = -step
    flow_bwd[1:, ..., 0] = step
    x = torch.arange(w, device=device, dtype=torch.float32)
    inside_fwd = ((x - step) >= 0).float()[None, None, :].expand(T, h, w).clone()
    inside_bwd = ((x + step) <= w - 1).float()[None, None, :].expand(T, h, w).clone()
    inside_fwd[-1] = 0
    inside_bwd[0] = 0
    mask = torch.zeros((T, h, w), device=device)
    return video, flow_fwd, flow_bwd, inside_fwd, inside_bwd, mask


def _disc_clip(gen, T, H, W, down, device):
    """A textured disc of radius 90 (the foreground, drifting 3 pixels right
    a frame and bobbing) over a texture that pans 2 pixels right a frame;
    the disc is the mask."""
    back = _cubic_noise(gen, H // 8 + 1, (W + 2 * T) // 8 + 1, H, W + 2 * T,
                        device)
    fore = _cubic_noise(gen, 180 // 5 + 1, 180 // 5 + 1, 180, 180,
                        device) * 0.6 + 90.0
    gains = _gains(gen, T, device)
    t = torch.arange(T, device=device, dtype=torch.float32)
    cx = 200.0 + 3.0 * t
    cy = H / 2 + 40.0 * torch.sin(t / 12.0)
    yy = torch.arange(H, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, None, :]
    inside = ((yy - cy[:, None, None]) ** 2 + (xx - cx[:, None, None]) ** 2
              < 90.0 ** 2)
    cols = 2 * (T - torch.arange(T, device=device))[:, None] + torch.arange(W, device=device)
    frames = back[:, cols].permute(1, 0, 2, 3).clone()      # (T, H, W, 3)
    fy = (yy - cy[:, None, None] + 90).clamp(0, 179).long().expand(T, H, W)
    fx = (xx - cx[:, None, None] + 90).clamp(0, 179).long().expand(T, H, W)
    frames = torch.where(inside[..., None], fore[fy, fx], frames)
    frames = frames * gains[:, None, None, None]
    video = _finish(frames, down)

    # the motion, in fit pixels, at the fit pixels' centres
    h, w = H // down, W // down
    ys = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) * down - 0.5
    xs = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) * down - 0.5

    def in_disc(k, px, py):
        return (py - cy[k]) ** 2 + (px - cx[k]) ** 2 < 90.0 ** 2

    flow_fwd = torch.zeros((T, h, w, 2), device=device)
    flow_bwd = torch.zeros((T, h, w, 2), device=device)
    mask_fwd = torch.zeros((T, h, w), device=device)
    mask_bwd = torch.zeros((T, h, w), device=device)
    gy, gx = ys[:, None].expand(h, w), xs[None, :].expand(h, w)
    for k in range(T):
        disc = in_disc(k, gx, gy)
        for other, flow, valid, sign in ((k + 1, flow_fwd, mask_fwd, 1.0),
                                         (k - 1, flow_bwd, mask_bwd, -1.0)):
            if not 0 <= other < T:
                continue
            dx = torch.where(disc, cx[other] - cx[k], torch.full_like(gx, 2.0 * sign))
            dy = torch.where(disc, cy[other] - cy[k], torch.zeros_like(gy))
            qx, qy = gx + dx, gy + dy
            flow[k, ..., 0] = dx / down
            flow[k, ..., 1] = dy / down
            valid[k] = ((qx >= 0) & (qx <= W - 1) & (qy >= 0) & (qy <= H - 1)
                        & (in_disc(other, qx, qy) == disc)).float()
    mask = ((gy[None] - cy[:, None, None]) ** 2 + (gx[None] - cx[:, None, None]) ** 2
            < 90.0 ** 2).float()
    return video, flow_fwd, flow_bwd, mask_fwd, mask_bwd, mask


CLIPS = {"pan": _pan_clip, "disc": _disc_clip}


def make_clips(kind: str, videos: int, frames: int, frame_size, down: int,
               seed: int, device) -> Dict[str, torch.Tensor]:
    """`videos` clips of `frames` frames of clip `kind`, each from its own
    stream of `seed`."""
    H, W = frame_size
    if H % down or W % down:
        raise ValueError(f"frame size {frame_size} does not divide by {down}")
    parts = []
    for v in range(videos):
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "clip", v))
        parts.append(CLIPS[kind](gen, frames, H, W, down, device))
    names = ("video", "flow_fwd", "flow_bwd", "mask_fwd", "mask_bwd", "mask")
    return {n: torch.stack([p[k] for p in parts]) for k, n in enumerate(names)}


def one_sided_differences(video: torch.Tensor):
    """(dx, dy): forward differences along width and height, zero on the
    last column / row."""
    dx = torch.zeros_like(video)
    dy = torch.zeros_like(video)
    dx[..., :, :-1, :] = video[..., :, 1:, :] - video[..., :, :-1, :]
    dy[..., :-1, :, :] = video[..., 1:, :, :] - video[..., :-1, :, :]
    return dx, dy


def fit_pack(clips: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The fit's gather pack (V, T, h, w, 16) in the layout the port's fit
    reads: rgb, dx, dy, flow_fwd, flow_bwd, mask_fwd, mask_bwd, mask."""
    dx, dy = one_sided_differences(clips["video"])
    return torch.cat([clips["video"], dx, dy, clips["flow_fwd"],
                      clips["flow_bwd"], clips["mask_fwd"][..., None],
                      clips["mask_bwd"][..., None], clips["mask"][..., None]],
                     dim=-1).contiguous()


def frames_uint_levels(kind: str, frames: int, frame_size, seed: int,
                       device) -> torch.Tensor:
    """One clip of `kind` at the frame size as levels in [0, 255] (what the
    flow stage reads from PNGs), (T, H, W, 3) float32."""
    clip = make_clips(kind, 1, frames, frame_size, 1, seed, device)
    return (clip["video"][0] * 255.0).round()
