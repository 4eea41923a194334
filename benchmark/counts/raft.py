"""RAFT's work, counted from the published architecture's shapes.

Model FLOPs of one flow direction: every convolution's products (2 x cin
x kernel x cout a output pixel) at its scale, the encoders once (the
feature encoder on both images), the update block once an iteration and
the mask head once; the correlation lookups as one D-long dot a window
position at each of the (2r+2)^2 integer positions that bilinear sampling
of a window reads, at every level and iteration; and the convex
upsampling (9 x 2 products a full-size pixel and component).  The
all-pairs volume is not counted: the lookups need only the windows.

The lookup's bound (`lookup_bound_s`): its bytes read and written once
(f1 in f32, the bf16 feature pyramid, the coordinates, the f32 output)
over the HBM rate, against its operations at the rates they can run at,
the needed dots (`needed_dots`: integer positions inside their level) on
the tensor cores and each output's 7-operation bilinear combination
outside them; the larger of the two.
"""

from __future__ import annotations

import torch

from ..reference.raft import FEATURES, LEVELS, RADIUS, conv_plan
from . import peaks


def direction_flops(H: int, W: int, iters: int) -> float:
    flops = 0.0
    for _, cin, cout, k, ho, wo, runs in conv_plan(H, W):
        runs = iters if runs < 0 else runs
        flops += runs * 2.0 * cin * k[0] * k[1] * cout * ho * wo
    pixels = (H // 8) * (W // 8)
    flops += iters * pixels * LEVELS * (2 * RADIUS + 2) ** 2 * 2.0 * FEATURES
    flops += H * W * 2 * 9 * 2.0
    return flops


def level_sizes(H8: int, W8: int):
    sizes = [(H8, W8)]
    for _ in range(LEVELS - 1):
        sizes.append((sizes[-1][0] // 2, sizes[-1][1] // 2))
    return sizes


def needed_dots(coords: torch.Tensor, H8: int, W8: int) -> int:
    """Window positions inside their level over every pixel and level of
    coords (B, H8, W8, 2): the dots a lookup needs (positions outside read
    zero and need none)."""
    r = RADIUS
    step = torch.arange(2 * r + 2, device=coords.device)
    dots = 0
    for l, (hl, wl) in enumerate(level_sizes(H8, W8)):
        lx = (coords[..., 0] / 2.0 ** l).clamp(-(r + 2.0), wl - 1.0 + r + 2.0)
        ly = (coords[..., 1] / 2.0 ** l).clamp(-(r + 2.0), hl - 1.0 + r + 2.0)
        ix = (torch.floor(lx).long() - r)[..., None] + step
        iy = (torch.floor(ly).long() - r)[..., None] + step
        nx = ((ix >= 0) & (ix < wl)).sum(-1)
        ny = ((iy >= 0) & (iy < hl)).sum(-1)
        dots += int((nx * ny).sum())
    return dots


def lookup_bound_s(directions: int, H8: int, W8: int, dots: float) -> float:
    D = FEATURES
    n_pix = directions * H8 * W8
    n_out = n_pix * LEVELS * (2 * RADIUS + 1) ** 2
    pyramid = sum(hl * wl for hl, wl in level_sizes(H8, W8))
    nbytes = (4.0 * n_pix * D + 2.0 * directions * pyramid * D
              + 4.0 * n_pix * 2 + 4.0 * n_out)
    t_ops = max(2.0 * D * dots / peaks.BF16_FLOPS, 7.0 * n_out / peaks.F32_FLOPS)
    return max(t_ops, nbytes / peaks.HBM_BYTES)
