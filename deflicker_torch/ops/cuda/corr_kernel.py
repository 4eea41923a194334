"""RAFT correlation-window lookup: the CUDA kernel's wrapper and its plain twin.

The CUDA source is `deflicker_torch/csrc/corr_lookup.cu` (its header says
which TPU kernel it replaces, its bound and its design).  This module:

  * `corr_lookup_cuda` checks its tensors, allocates the output with
    `torch.empty`, launches on the current stream without synchronising,
    raises on a non-zero `cudaGetLastError()`, and counts lookups in
    `launches["lookup"]` (one per call: the four levels are one launch);
  * `corr_lookup_plain` is the same function in plain PyTorch, by gathers in
    pixel chunks: f2 is read from whatever dtype the pyramid is stored in
    (bf16 for the kernel's twin, f32 for the online mode of models/raft.py)
    and every product and sum is f32.  CPU tests and the on-card comparison
    use it; nothing on the main path does when the tensors are on the card.

Both compute, for pixel p, level l and c = coords[p] / 2^l (clamped to
[-(r+2), size-1+r+2], which changes no value: a window it moves was all zero
and stays all zero),

    out[p, l*K*K + i*K + j] = <f1[p], bilinear(f2_l, c.x + i - r, c.y + j - r)> / sqrt(D)

with K = 2r+1, the x offset on the OUTER index i, and zeros outside the
level.  All K*K points share one fractional offset, so both take the
(K+1)^2 dot products at integer positions first and interpolate after.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

MAX_LEVELS = 8
KERNEL_RADIUS = 4
KERNEL_DIMS = (32, 64, 128, 256)

# lookups launched by `corr_lookup_cuda` (one kernel launch per call)
launches = {"lookup": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _level_sizes(H: int, W: int, n: int):
    sizes = [(H, W)]
    for _ in range(n - 1):
        sizes.append((sizes[-1][0] // 2, sizes[-1][1] // 2))
    return sizes


def _check_shapes(fmap1, pyramid, coords) -> None:
    if fmap1.dim() != 4 or coords.shape != fmap1.shape[:3] + (2,):
        raise ValueError(f"need fmap1 (B, H, W, D) and coords (B, H, W, 2), "
                         f"got {tuple(fmap1.shape)} {tuple(coords.shape)}")
    B, H, W, D = fmap1.shape
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"need 1..{MAX_LEVELS} pyramid levels")
    for lvl, (hl, wl) in zip(pyramid, _level_sizes(H, W, len(pyramid))):
        if tuple(lvl.shape) != (B, hl, wl, D):
            raise ValueError(f"pyramid level {tuple(lvl.shape)}, want "
                             f"{(B, hl, wl, D)} (floor-halved levels)")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def corr_lookup_plain(fmap1: torch.Tensor, fmap2_pyramid: Sequence[torch.Tensor],
                      coords: torch.Tensor, radius: int = KERNEL_RADIUS,
                      chunk: int = 2048) -> torch.Tensor:
    """fmap1 (B, H, W, D), pyramid [(B, H_l, W_l, D)] in any float dtype,
    coords (B, H, W, 2) (x, y) -> (B, H, W, L*(2r+1)^2) float32.  Live
    memory is O(chunk * (2r+2)^2 * D)."""
    _check_shapes(fmap1, fmap2_pyramid, coords)
    B, H, W, D = fmap1.shape
    N = H * W
    K, K1 = 2 * radius + 1, 2 * radius + 2
    dev = fmap1.device
    f1 = fmap1.reshape(B * N, D).float()
    cx = coords[..., 0].reshape(B * N).float()
    cy = coords[..., 1].reshape(B * N).float()
    batch = torch.arange(B, device=dev).repeat_interleave(N)
    step = torch.arange(K1, device=dev)
    inv_sqrt_d = 1.0 / math.sqrt(D)

    out = torch.zeros((B * N, len(fmap2_pyramid), K, K), dtype=torch.float32,
                      device=dev)
    for l, lvl in enumerate(fmap2_pyramid):
        Hl, Wl = lvl.shape[1], lvl.shape[2]
        if Hl * Wl == 0:
            continue                     # an empty level reads zeros everywhere
        flat = lvl.reshape(B * Hl * Wl, D)
        for s in range(0, B * N, chunk):
            e = min(s + chunk, B * N)
            lx = (cx[s:e] / 2.0 ** l).clamp(-(radius + 2.0), Wl - 1.0 + radius + 2.0)
            ly = (cy[s:e] / 2.0 ** l).clamp(-(radius + 2.0), Hl - 1.0 + radius + 2.0)
            fx, fy = torch.floor(lx), torch.floor(ly)
            wx = (lx - fx)[:, None, None]
            wy = (ly - fy)[:, None, None]
            # integer positions (C, K1 over x, K1 over y)
            ix = (fx.long() - radius)[:, None, None] + step[None, :, None]
            iy = (fy.long() - radius)[:, None, None] + step[None, None, :]
            valid = (ix >= 0) & (ix < Wl) & (iy >= 0) & (iy < Hl)
            idx = (batch[s:e, None, None] * (Hl * Wl)
                   + iy.clamp(0, Hl - 1) * Wl + ix.clamp(0, Wl - 1))
            feats = flat[idx.reshape(-1)].reshape(e - s, K1 * K1, D).float()
            dots = torch.einsum("cpd,cd->cp", feats, f1[s:e]).reshape(e - s, K1, K1)
            t = torch.where(valid, dots, 0.0)
            out[s:e, l] = (((t[:, :K, :K] * (1 - wx) + t[:, 1:, :K] * wx) * (1 - wy)
                            + (t[:, :K, 1:] * (1 - wx) + t[:, 1:, 1:] * wx) * wy)
                           * inv_sqrt_d)
    return out.reshape(B, H, W, len(fmap2_pyramid) * K * K)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

class _CorrDesc(ctypes.Structure):
    """Mirror of `struct CorrDesc` in csrc/corr_lookup.cu."""

    _fields_ = [("n_levels", ctypes.c_int),
                ("H", ctypes.c_int * MAX_LEVELS),
                ("W", ctypes.c_int * MAX_LEVELS),
                ("f2", ctypes.c_void_p * MAX_LEVELS)]


def _library():
    from .build import load

    lib = load("corr_lookup")
    if not getattr(lib, "_deflicker_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.corr_lookup.argtypes = [P, P, P, P, I, I, I, I, P]
        lib.corr_lookup.restype = I
        lib._deflicker_typed = True
    return lib


def corr_lookup_cuda(fmap1: torch.Tensor, fmap2_pyramid: Sequence[torch.Tensor],
                     coords: torch.Tensor, radius: int = KERNEL_RADIUS
                     ) -> torch.Tensor:
    """Kernel launch: fmap1 (B, H, W, D) f32, pyramid [(B, H_l, W_l, D)]
    bf16 with floor-halved levels, coords (B, H, W, 2) f32, all contiguous
    on one CUDA device -> (B, H, W, L*81) f32.  D in {32, 64, 128, 256},
    radius 4."""
    if not fmap1.is_cuda:
        raise ValueError("the CUDA correlation kernel needs CUDA tensors")
    _check_shapes(fmap1, fmap2_pyramid, coords)
    B, H, W, D = fmap1.shape
    if radius != KERNEL_RADIUS or D not in KERNEL_DIMS:
        raise ValueError(f"the kernel takes radius {KERNEL_RADIUS} and D in "
                         f"{KERNEL_DIMS}, got radius {radius}, D {D}")
    for name, t in (("fmap1", fmap1), ("coords", coords)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != fmap1.device or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous float32 on {fmap1.device}")
    d = _CorrDesc()
    d.n_levels = len(fmap2_pyramid)
    for l, lvl in enumerate(fmap2_pyramid):
        if lvl.dtype != torch.bfloat16 or not lvl.is_contiguous() \
                or lvl.device != fmap1.device or lvl.data_ptr() % 16:
            raise ValueError(f"pyramid level {l} must be contiguous bfloat16 "
                             f"on {fmap1.device}")
        d.H[l], d.W[l] = lvl.shape[1], lvl.shape[2]
        d.f2[l] = lvl.data_ptr()
    K = 2 * radius + 1
    out = torch.empty((B, H, W, d.n_levels * K * K), dtype=torch.float32,
                      device=fmap1.device)
    if B * H * W == 0:
        return out
    err = _library().corr_lookup(
        ctypes.byref(d), fmap1.data_ptr(), coords.data_ptr(), out.data_ptr(),
        B, H * W, D, radius,
        torch.cuda.current_stream(fmap1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"corr_lookup failed: CUDA error {err}")
    launches["lookup"] += 1
    return out
