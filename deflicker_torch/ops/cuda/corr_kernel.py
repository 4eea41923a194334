"""RAFT correlation-window lookup: the CUDA kernel's wrapper and its plain twin.

The CUDA source is `deflicker_torch/csrc/corr_lookup.cu` (its header says
which TPU kernels it replaces, its bound and its design).  It holds one
function under three memory schedules ("bodies"): "band" (the default),
"shared" (a block stages the union window of its 8 pixels in shared memory
when the windows cluster) and "resident" (small levels held whole in shared
memory).  This module:

  * `corr_lookup_cuda` checks its tensors, allocates the output with
    `torch.empty`, launches the chosen body on the current stream without
    synchronising, raises on a non-zero `cudaGetLastError()`, and counts
    lookups in `launches["lookup"]`, `["lookup_shared"]` or
    `["lookup_resident"]` (one per call: the four levels are one launch);
  * `select_body` reads the JAX package's switches (DEFLICKER_CORR_SHARED,
    DEFLICKER_CORR_RESIDENT; the shared body wins, as in
    `corr_lookup_pallas`), and `resident_levels` picks the levels the
    resident body keeps in shared memory (DEFLICKER_CORR_RESIDENT_MAX_MB
    gates a level's bytes per batch element, capped by what a block's
    shared memory holds);
  * `corr_lookup_plain` is the same function in plain PyTorch, by gathers in
    pixel chunks: f2 is read from whatever dtype the pyramid is stored in
    (bf16 for the kernel's twin, f32 for the online mode of models/raft.py)
    and every product and sum is f32.  It is the twin of all three bodies
    (they compute one function).  CPU tests and the on-card comparison use
    it; nothing on the main path does when the tensors are on the card.

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
import os
from typing import Optional, Sequence, Tuple

import torch

MAX_LEVELS = 8
KERNEL_RADIUS = 4
KERNEL_DIMS = (32, 64, 128, 256)

BODIES = ("band", "shared", "resident")
_BODY_CODE = {"band": 0, "shared": 1, "resident": 2}
_COUNTER = {"band": "lookup", "shared": "lookup_shared",
            "resident": "lookup_resident"}

# lookups launched by `corr_lookup_cuda`, by body (one kernel launch per call)
launches = {"lookup": 0, "lookup_shared": 0, "lookup_resident": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def select_body() -> str:
    """The body the JAX package's switches select: DEFLICKER_CORR_SHARED=1
    takes precedence over DEFLICKER_CORR_RESIDENT=1 (as in
    `corr_lookup_pallas`); neither set is the band body."""
    if os.environ.get("DEFLICKER_CORR_SHARED", "0") == "1":
        return "shared"
    if os.environ.get("DEFLICKER_CORR_RESIDENT", "0") == "1":
        return "resident"
    return "band"


def resident_gate_bytes() -> Optional[int]:
    """DEFLICKER_CORR_RESIDENT_MAX_MB in bytes, or None when unset.  The
    JAX package's 5 MB default sized TPU VMEM; here a block's shared memory
    is the only default limit."""
    mb = os.environ.get("DEFLICKER_CORR_RESIDENT_MAX_MB")
    return int(float(mb) * 1024 * 1024) if mb else None


def resident_levels(level_shapes: Sequence[Tuple[int, int]], D: int,
                    capacity: int, gate: Optional[int] = None
                    ) -> Tuple[int, ...]:
    """The levels the resident body holds in shared memory: from the
    coarsest up, each level whose bf16 bytes per batch element (H_l W_l D 2)
    pass `gate` (when given) while the kept levels' sum fits `capacity`.
    The others take the band body's loads inside the same launch."""
    kept, used = [], 0
    limit = capacity if gate is None else min(gate, capacity)
    for l in reversed(range(len(level_shapes))):
        hl, wl = level_shapes[l]
        nbytes = hl * wl * D * 2
        if 0 < nbytes <= limit and used + nbytes <= capacity:
            kept.append(l)
            used += nbytes
    return tuple(sorted(kept))


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
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.corr_lookup.argtypes = [P, P, P, P, I, I, I, I, I, U, I, P, P]
        lib.corr_lookup.restype = I
        lib.corr_resident_capacity.argtypes = []
        lib.corr_resident_capacity.restype = ctypes.c_longlong
        lib._deflicker_typed = True
    return lib


def resident_capacity() -> int:
    """Bytes of a block's shared memory the resident body can give to
    levels on the current CUDA device."""
    cap = _library().corr_resident_capacity()
    if cap < 0:
        raise RuntimeError("corr_resident_capacity failed: no CUDA device")
    return int(cap)


def _resident_tile(B: int, N: int, device) -> int:
    """Pixels a resident block covers: about one wave of one block per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = max(1, sms // B)
    return -(-N // tiles)


def corr_lookup_cuda(fmap1: torch.Tensor, fmap2_pyramid: Sequence[torch.Tensor],
                     coords: torch.Tensor, radius: int = KERNEL_RADIUS,
                     body: str = "band", staged: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Kernel launch: fmap1 (B, H, W, D) f32, pyramid [(B, H_l, W_l, D)]
    bf16 with floor-halved levels, coords (B, H, W, 2) f32, all contiguous
    on one CUDA device -> (B, H, W, L*81) f32.  D in {32, 64, 128, 256},
    radius 4.  `body` is one of BODIES; for "shared", `staged` may be an
    int32 tensor of L zeros on the device, to which the kernel adds the
    number of blocks that staged their union window at each level."""
    if not fmap1.is_cuda:
        raise ValueError("the CUDA correlation kernel needs CUDA tensors")
    if body not in BODIES:
        raise ValueError(f"unknown correlation body {body!r}, want one of {BODIES}")
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
    if staged is not None and (body != "shared" or staged.dtype != torch.int32
                               or staged.shape != (d.n_levels,)
                               or staged.device != fmap1.device):
        raise ValueError(f"staged must be an int32 ({d.n_levels},) tensor on "
                         f"{fmap1.device}, with the shared body")
    K = 2 * radius + 1
    out = torch.empty((B, H, W, d.n_levels * K * K), dtype=torch.float32,
                      device=fmap1.device)
    if B * H * W == 0:
        return out
    lib = _library()
    mask, tile = 0, 1
    if body == "resident":
        keep = resident_levels([tuple(lvl.shape[1:3]) for lvl in fmap2_pyramid],
                               D, resident_capacity(), resident_gate_bytes())
        mask = sum(1 << l for l in keep)
        tile = _resident_tile(B, H * W, fmap1.device)
    err = lib.corr_lookup(
        ctypes.byref(d), fmap1.data_ptr(), coords.data_ptr(), out.data_ptr(),
        B, H * W, D, radius, _BODY_CODE[body], mask, tile,
        staged.data_ptr() if staged is not None else None,
        torch.cuda.current_stream(fmap1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"corr_lookup ({body} body) failed: CUDA error {err}")
    launches[_COUNTER[body]] += 1
    return out
