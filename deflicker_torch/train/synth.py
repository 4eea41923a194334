"""Procedural training clips for stage-2 training, made on the device.

The JAX package's `train/synth.py`: the reference ships its stage-2
networks only as pretrained downloads, so the trainer makes its own data.
Every clip has an exact clean sequence, its flickered input, a "flawed
atlas" analog (temporally consistent but blurry, colour-shifted and
slightly misaligned, as a stage-1 atlas is) and the exact backward flow:

  frame_t(p)   = tex(A_t p)            A_t: smooth random affine trajectory
  flow_bw_t(p) = A_{t-1}^{-1}(A_t p - o_{t-1}) - p
  atlas_t(p)   = tex_lowpass(A_t p + d(A_t p)) + shift
  input_t(p)   = clip(frame_t(p) * gain_t * field_t(p) + bias_t, 0, 1)

`tex` is a sum of random Fourier features (`make_clip`) or a real image
(`make_image_clip`); an optional foreground layer (probability `p_layer`)
rides its own trajectory through a soft ellipse, which makes the flow
layered and `Clip.valid` exclude occlusions and the mask's edge band;
`corr_flicker` draws AR(1) gain and bias series instead of iid ones.

A clip is made in two steps, each batched over a leading clip axis:
`draw_clips` takes a `torch.Generator` and returns every random number the
clips use (`ClipDraws`), and `build_clips` is a pure function of those
draws.  The tests feed the JAX package's own draws through `build_clips`.
The build step stays in f32 with exact products: the texture phases reach
~200 rad, where one bf16 or TF32 product moves a cosine by O(1), so every
2-term product is written out elementwise and the resize products run in
f64 (never TF32, never autocast).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.coords import coords_grid
from ..ops.sampling import bilinear_sample

_TWO_PI = 2.0 * math.pi


class Clip(NamedTuple):
    """All tensors f32, images in [0, 1]; (T, ...) for one clip, (B, T, ...)
    from `build_clips`."""

    clean: torch.Tensor     # (T, H, W, 3) ground truth (consistent, sharp)
    inp: torch.Tensor       # (T, H, W, 3) flickered input
    atlas: torch.Tensor     # (T, H, W, 3) flawed-atlas analog
    flow_bw: torch.Tensor   # (T, H, W, 2) frame t -> t-1 (t = 0: zeros)
    valid: torch.Tensor     # (T, H, W, 1) 1 where the t -> t-1 correspondence
    #                         is exact: in bounds, off the mask's edge band,
    #                         not occluded at t-1 (valid[0] = 1)


class Texture(NamedTuple):
    """Random Fourier texture: freqs (B, K, 2) cycles/px, phases (B, K, 3),
    amps (B, K, 3) with a 1/f spectrum."""

    freqs: torch.Tensor
    phases: torch.Tensor
    amps: torch.Tensor


class ClipDraws(NamedTuple):
    """Every random number of B clips (leading axis B)."""

    tex: Optional[Texture]       # background texture; None: an image clip
    M: torch.Tensor              # (B, T, 2, 2) background trajectory ...
    off: torch.Tensor            # (B, T, 2)   ... u = M p + off
    start: Optional[torch.Tensor]  # (B, 2) in [-0.5, 0.5): image clips' start
    shift: torch.Tensor          # (B, 3) atlas colour shift
    warp: Texture                # 8-frequency misalignment texture
    fg_tex: Texture
    fg_M: torch.Tensor
    fg_off: torch.Tensor
    fg_shift: torch.Tensor
    fg_warp: Texture
    ellipse: tuple               # centre (B, 2), radii (B, 2), angle (B,)
    fg_on: torch.Tensor          # (B,) 1.0 where the clip has the layer
    gain: torch.Tensor           # (B, T, 3) iid: gain offsets; AR(1): innovations
    bias: torch.Tensor           # (B, T, 3) the same for the bias
    rho: Optional[torch.Tensor]  # (B, 2) AR(1) rho of gain and bias; None: iid
    field: torch.Tensor          # (B, T, 3, 4) spatial gain field, before 1 +


# ---------------------------------------------------------------------------
# the draw step
# ---------------------------------------------------------------------------

def _uniform(gen, shape, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (hi - lo) + lo


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _draw_texture(gen, B: int, K: int, min_period: float,
                  max_period: float) -> Texture:
    mag = torch.exp(_uniform(gen, (B, K), math.log(1.0 / max_period),
                             math.log(1.0 / min_period)))
    ang = _uniform(gen, (B, K), 0.0, _TWO_PI)
    freqs = mag[..., None] * torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    phases = _uniform(gen, (B, K, 3), 0.0, _TWO_PI)
    amps = _normal(gen, (B, K, 3)) / (mag[..., None] * max_period)
    amps = amps / torch.sqrt(torch.sum(amps ** 2, dim=1, keepdim=True) + 1e-8)
    return Texture(freqs, phases, amps)


def _draw_trajectory(gen, B: int, T: int, H: int, W: int,
                     trans_px: float = 1.5):
    """Gaussian random walks in translation, rotation and log-zoom; returns
    (M (B, T, 2, 2), off (B, T, 2)) about the image centre."""
    trans = torch.cumsum(_normal(gen, (B, T, 2)) * trans_px, dim=1)
    rot = torch.cumsum(_normal(gen, (B, T)) * 0.008, dim=1)
    zoom = torch.exp(torch.cumsum(_normal(gen, (B, T)) * 0.004, dim=1))
    c, s = torch.cos(rot), torch.sin(rot)
    M = zoom[..., None, None] * torch.stack(
        [torch.stack([c, -s], -1), torch.stack([s, c], -1)], dim=-2)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    # offset = center + trans - M center, with the centre as Python scalars
    # (a host tensor would be one more copy, and a stream sync, a step)
    off = torch.stack([cx + trans[..., 0] - (M[..., 0, 0] * cx + M[..., 0, 1] * cy),
                       cy + trans[..., 1] - (M[..., 1, 0] * cx + M[..., 1, 1] * cy)],
                      dim=-1)
    return M, off


def draw_clips(gen: torch.Generator, B: int, T: int, H: int, W: int, *,
               image: bool = False, n_freqs: int = 48,
               flicker_gain: float = 0.25, flicker_bias: float = 0.08,
               local_gain: float = 0.15, atlas_shift: float = 0.06,
               p_layer: float = 0.0, corr_flicker: bool = False) -> ClipDraws:
    """The random numbers of B clips, drawn on `gen`'s device.  `image`:
    clips whose background is a texture image (`build_clips(textures=)`),
    so no background Fourier texture is drawn but a start point is."""
    tex = None if image else _draw_texture(gen, B, n_freqs, 4.0, 96.0)
    M, off = _draw_trajectory(gen, B, T, H, W)
    start = _uniform(gen, (B, 2), -0.5, 0.5) if image else None
    shift = _uniform(gen, (B, 3), -atlas_shift, atlas_shift)
    warp = _draw_texture(gen, B, 8, 24.0, 128.0)
    fg_tex = _draw_texture(gen, B, 48 if image else n_freqs, 4.0, 96.0)
    fg_M, fg_off = _draw_trajectory(gen, B, T, H, W, trans_px=2.5)
    fg_shift = _uniform(gen, (B, 3), -atlas_shift, atlas_shift)
    fg_warp = _draw_texture(gen, B, 8, 24.0, 128.0)
    def wh(u):                                  # (W, H) * u, u (B, 2)
        return torch.stack([W * u[:, 0], H * u[:, 1]], dim=-1)

    ellipse = (wh(0.25 + 0.5 * _uniform(gen, (B, 2))),
               wh(0.10 + 0.18 * _uniform(gen, (B, 2))),
               _uniform(gen, (B,), 0.0, math.pi))
    fg_on = (_uniform(gen, (B,)) < p_layer).float()
    if corr_flicker:
        rho = _uniform(gen, (B, 2), 0.0, 0.9)
        gain, bias = _normal(gen, (B, T, 3)), _normal(gen, (B, T, 3))
    else:
        rho = None
        gain = _uniform(gen, (B, T, 3), -flicker_gain, flicker_gain)
        bias = _uniform(gen, (B, T, 3), -flicker_bias, flicker_bias)
    field = _uniform(gen, (B, T, 3, 4), -local_gain, local_gain)
    return ClipDraws(tex, M, off, start, shift, warp, fg_tex, fg_M, fg_off,
                     fg_shift, fg_warp, ellipse, fg_on, gain, bias, rho, field)


# ---------------------------------------------------------------------------
# the build step: pure functions of the draws, f32, exact products
# ---------------------------------------------------------------------------

def _per_clip(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B, *rest) -> (B, 1 x ndim, *rest), to broadcast over (T, H, W)."""
    return x.reshape(x.shape[:1] + (1,) * ndim + x.shape[1:])


def _frame_coords(M, off, grid):
    """u = M_t p + o_t for every pixel: (B, T, H, W, 2)."""
    M = M[:, :, None, None]
    o = off[:, :, None, None]
    gx, gy = grid[..., 0], grid[..., 1]
    return torch.stack([M[..., 0, 0] * gx + M[..., 0, 1] * gy + o[..., 0],
                        M[..., 1, 0] * gx + M[..., 1, 1] * gy + o[..., 1]], -1)


def _eval_texture(u, tex: Texture, gain: float = 2.5):
    """tex(u): u (B, T, H, W, 2) px -> rgb (B, T, H, W, 3) in [0, 1]."""
    f = _per_clip(tex.freqs, 3)                          # (B, 1, 1, 1, K, 2)
    ph = _TWO_PI * (u[..., 0:1] * f[..., 0] + u[..., 1:2] * f[..., 1])
    val = torch.cos(ph[..., None] + _per_clip(tex.phases, 3)) \
        * _per_clip(tex.amps, 3)                         # (B, T, H, W, K, 3)
    return 0.5 + 0.5 * torch.tanh(gain * torch.sum(val, dim=-2))


def _atlas(cds, tex: Texture, shift, warp: Texture, warp_px: float,
           blur_period: float):
    """The flawed atlas of a Fourier layer: its low-pass texture (the atlas
    blur) at statically displaced coordinates, plus a colour shift."""
    fmag = torch.sqrt(torch.sum(tex.freqs ** 2, dim=-1))
    lp = tex._replace(amps=tex.amps * (fmag < 1.0 / blur_period)[..., None])
    disp = (_eval_texture(cds, warp) - 0.5)[..., :2] * (2.0 * warp_px)
    return torch.clamp(_eval_texture(cds + disp, lp)
                       + _per_clip(shift, 3), 0.0, 1.0)


def _inv2(M):
    a, b, c, d = M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1]
    det = a * d - b * c
    return torch.stack([torch.stack([d, -b], -1),
                        torch.stack([-c, a], -1)], -2) / det[..., None, None]


def _apply2(M, v):
    """M (..., 2, 2) times v (..., 2), written out."""
    return torch.stack([M[..., 0, 0] * v[..., 0] + M[..., 0, 1] * v[..., 1],
                        M[..., 1, 0] * v[..., 0] + M[..., 1, 1] * v[..., 1]], -1)


def _backward_flow(coords, M, off, grid):
    """flow_bw[t](p) = A_{t-1}^{-1}(A_t p - o_{t-1}) - p; zero t = 0 row."""
    Minv = _inv2(M)[:, :-1, None, None]
    p_prev = _apply2(Minv, coords[:, 1:] - off[:, :-1, None, None])
    return torch.cat([torch.zeros_like(coords[:, :1]), p_prev - grid], dim=1)


def _ellipse_mask(u, ellipse, sharpness: float = 12.0):
    """~1 inside the ellipse, ~0 outside, a smooth edge: (..., 1)."""
    c, rad, ang = (_per_clip(x, 3) for x in ellipse)
    d = u - c
    ca, sa = torch.cos(ang), torch.sin(ang)
    x = (d[..., 0] * ca + d[..., 1] * sa) / rad[..., 0]
    y = (-d[..., 0] * sa + d[..., 1] * ca) / rad[..., 1]
    r = torch.sqrt(x * x + y * y + 1e-8)
    return torch.sigmoid(sharpness * (1.0 - r))[..., None]


def _layered_flow_valid(grid, H: int, W: int, m, flow_bg, flow_fg, d):
    """The visible surface's flow (foreground where m > 0.5) and its
    validity: in bounds AND (a foreground pixel, m > 0.8, always
    corresponded since the mask rides the surface; OR a background pixel,
    m < 0.2, not under the foreground at t-1); the edge band is out."""
    flow = torch.where(m > 0.5, flow_fg, flow_bg)
    inb = warp_valid_mask(flow, H, W)
    p_prev = grid + flow
    u = _apply2(d.fg_M[:, :-1, None, None], p_prev[:, 1:]) \
        + d.fg_off[:, :-1, None, None]
    mp = _ellipse_mask(u, d.ellipse) * _per_clip(d.fg_on, 4)
    mp = torch.cat([torch.zeros_like(m[:, :1]), mp], dim=1)
    ok = (m > 0.8) | ((m < 0.2) & (mp < 0.2))
    valid = inb * ok.float()
    valid[:, 0] = 1.0
    return flow, valid


def _ar1_series(rho, e, bound: float):
    """A stationary AR(1) series per clip from innovations e (B, T, 3),
    squashed by tanh to +-bound."""
    T = e.shape[1]
    idx = torch.arange(T, device=e.device)
    expo = torch.clamp(idx[:, None] - idx[None, :], min=0).float()
    L = torch.tril(rho[:, None, None] ** expo)
    scale = torch.where(idx[None, None, :] == 0, 1.0,
                        torch.sqrt(torch.clamp(1.0 - rho ** 2, min=1e-6)
                                   )[:, None, None])
    w = torch.sum((L * scale)[..., None] * e[:, None], dim=2)  # (B, T, 3)
    return bound * torch.tanh(w)


def _resize_weights(m: int, n: int, device) -> torch.Tensor:
    """The (m, n) weights of `jax.image.resize(..., "linear")` along one
    axis (jax's `compute_weight_mat`: half-pixel centres, a triangle kernel
    widened by the scale when downsampling, columns normalized, samples
    outside the input zero), in f32 as jax computes them, on `device`."""
    inv_scale = np.float32(1.0) / np.float32(n / m)
    kernel_scale = max(float(inv_scale), 1.0)
    sample_f = ((torch.arange(n, dtype=torch.float32, device=device) + 0.5)
                * float(inv_scale) - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(
        m, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_linear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """`jax.image.resize(x, (..., out_h, out_w, C), "linear")` of
    (..., h, w, C): both axes' weight matrices applied as products in f64
    (f32-exact whatever the TF32 or autocast setting), returned in f32."""
    h, w = x.shape[-3], x.shape[-2]
    wy = _resize_weights(h, out_h, x.device).double()
    wx = _resize_weights(w, out_w, x.device).double()
    y = torch.einsum("...ijc,ia,jb->...abc", x.double(), wy, wx)
    return y.float()


def _flicker(clean, d: ClipDraws, H: int, W: int, flicker_gain: float,
             flicker_bias: float):
    """clip(clean * gain_t * field_t + bias_t, 0, 1)."""
    if d.rho is None:
        g, b = 1.0 + d.gain, d.bias
    else:
        g = 1.0 + _ar1_series(d.rho[:, 0], d.gain, flicker_gain)
        b = _ar1_series(d.rho[:, 1], d.bias, flicker_bias)
    g, b = g[:, :, None, None], b[:, :, None, None]
    field = 1.0 + resize_linear(d.field[..., None], H, W)
    return torch.clamp(clean * g * field + b, 0.0, 1.0)


def build_clips(d: ClipDraws, H: int, W: int, *,
                textures: Optional[torch.Tensor] = None,
                flicker_gain: float = 0.25, flicker_bias: float = 0.08,
                atlas_warp_px: float = 2.0, blur_period: float = 12.0) -> Clip:
    """B clips (leading axis) from their draws.  An image clip (`d.tex` is
    None) samples its background from `textures` (B, Ht, Wt, 3), f32 in
    [0, 1] and larger than (H, W) by a margin, zeros outside; its atlas
    blurs the texture by a down-by-6 / up resize."""
    dev = d.M.device
    grid = coords_grid(H, W, device=dev)
    M, off = d.M, d.off
    if d.tex is None:
        Ht, Wt = textures.shape[1], textures.shape[2]
        mx, my = (Wt - W) / 2.0, (Ht - H) / 2.0
        start = torch.stack([mx + d.start[:, 0] * mx * 0.5,
                             my + d.start[:, 1] * my * 0.5], dim=-1)
        M, off = 0.92 * M, off + start[:, None]
        coords = _frame_coords(M, off, grid)
        blur = resize_linear(resize_linear(textures, max(Ht // 6, 1),
                                           max(Wt // 6, 1)), Ht, Wt)
        disp = (_eval_texture(coords, d.warp) - 0.5)[..., :2] \
            * (2.0 * atlas_warp_px)
        clean_bg = torch.stack([bilinear_sample(t, c)
                                for t, c in zip(textures, coords)])
        atlas_bg = torch.clamp(
            torch.stack([bilinear_sample(t, c)
                         for t, c in zip(blur, coords + disp)])
            + _per_clip(d.shift, 3), 0.0, 1.0)
        fg_blur = 12.0
    else:
        coords = _frame_coords(M, off, grid)
        clean_bg = _eval_texture(coords, d.tex)
        atlas_bg = _atlas(coords, d.tex, d.shift, d.warp, atlas_warp_px,
                          blur_period)
        fg_blur = blur_period
    flow_bg = _backward_flow(coords, M, off, grid)

    fg_coords = _frame_coords(d.fg_M, d.fg_off, grid)
    fg_clean = _eval_texture(fg_coords, d.fg_tex)
    fg_atlas = _atlas(fg_coords, d.fg_tex, d.fg_shift, d.fg_warp,
                      atlas_warp_px, fg_blur)
    m = _ellipse_mask(fg_coords, d.ellipse) * _per_clip(d.fg_on, 4)
    clean = m * fg_clean + (1.0 - m) * clean_bg
    atlas = m * fg_atlas + (1.0 - m) * atlas_bg
    flow_fg = _backward_flow(fg_coords, d.fg_M, d.fg_off, grid)
    flow_bw, valid = _layered_flow_valid(grid, H, W, m, flow_bg, flow_fg, d)
    inp = _flicker(clean, d, H, W, flicker_gain, flicker_bias)
    return Clip(clean, inp, atlas, flow_bw, valid)


# ---------------------------------------------------------------------------
# one clip, as the JAX package's functions make it
# ---------------------------------------------------------------------------

@torch.no_grad()
def make_clip(gen: torch.Generator, T: int, H: int, W: int,
              n_freqs: int = 48, flicker_gain: float = 0.25,
              flicker_bias: float = 0.08, local_gain: float = 0.15,
              atlas_shift: float = 0.06, atlas_warp_px: float = 2.0,
              blur_period: float = 12.0, p_layer: float = 0.0,
              corr_flicker: bool = False) -> Clip:
    """One Fourier-texture clip on `gen`'s device.  The defaults are the
    affine/iid distribution the shipped stage-2 weights were trained on."""
    d = draw_clips(gen, 1, T, H, W, n_freqs=n_freqs,
                   flicker_gain=flicker_gain, flicker_bias=flicker_bias,
                   local_gain=local_gain, atlas_shift=atlas_shift,
                   p_layer=p_layer, corr_flicker=corr_flicker)
    c = build_clips(d, H, W, flicker_gain=flicker_gain,
                    flicker_bias=flicker_bias, atlas_warp_px=atlas_warp_px,
                    blur_period=blur_period)
    return Clip(*(x[0] for x in c))


@torch.no_grad()
def make_image_clip(gen: torch.Generator, tex: torch.Tensor, T: int, H: int,
                    W: int, flicker_gain: float = 0.25,
                    flicker_bias: float = 0.08, local_gain: float = 0.15,
                    atlas_shift: float = 0.06, atlas_warp_px: float = 2.0,
                    p_layer: float = 0.0, corr_flicker: bool = False) -> Clip:
    """One clip whose background is the image `tex` (Ht, Wt, 3), f32 in
    [0, 1] and larger than (H, W) by a margin, on the same camera and flow
    machinery; the optional foreground layer is a Fourier texture."""
    d = draw_clips(gen, 1, T, H, W, image=True, flicker_gain=flicker_gain,
                   flicker_bias=flicker_bias, local_gain=local_gain,
                   atlas_shift=atlas_shift, p_layer=p_layer,
                   corr_flicker=corr_flicker)
    c = build_clips(d, H, W, textures=tex[None], flicker_gain=flicker_gain,
                    flicker_bias=flicker_bias, atlas_warp_px=atlas_warp_px)
    return Clip(*(x[0] for x in c))


def load_texture_bank(texture_dir, tex_h: int, tex_w: int,
                      max_textures: int = 64) -> Optional[np.ndarray]:
    """Host side: up to `max_textures` frames or images of a directory,
    evenly spaced, each resized (INTER_AREA) to (tex_h, tex_w), as a
    (N, tex_h, tex_w, 3) f32 bank; None when it holds no image."""
    from pathlib import Path

    import cv2

    from ..io.media import list_frames, read_image

    texture_dir = Path(texture_dir)
    names = list_frames(texture_dir) if texture_dir.is_dir() else []
    if not names:
        return None
    step = max(1, len(names) // max_textures)
    bank = []
    for p in names[::step][:max_textures]:
        img = read_image(p).astype(np.float32)   # RGB in [0, 1]
        if img.shape[:2] != (tex_h, tex_w):
            img = cv2.resize(img, (tex_w, tex_h), interpolation=cv2.INTER_AREA)
        bank.append(img[..., :3])
    return np.stack(bank)


def warp_valid_mask(flow: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """1.0 where p + flow(p) lands inside the image (flow_warp reads zeros
    outside, so temporal losses leave those pixels out).  flow: (..., H, W, 2)."""
    tgt = coords_grid(H, W, device=flow.device) + flow
    ok = ((tgt[..., 0] >= 0) & (tgt[..., 0] <= W - 1)
          & (tgt[..., 1] >= 0) & (tgt[..., 1] <= H - 1))
    return ok.float()[..., None]
