"""GMA's global motion aggregation: the CUDA kernels' wrappers and their
plain twin.

The CUDA source is `deflicker_torch/csrc/gma_attention.cu` (its header says
what it replaces, its bound and its design: P, the softmax attention over
the context features, stored once a solve in bf16 and read by every GRU
iteration's aggregation).  Both compute, for direction b, q and k the two
`DIM`-channel halves of each row of qk (B, N, 2 DIM), c = log2(e) /
sqrt(DIM):

    x_ij = c <q_i, k_j>,  m_i = max_j x_ij,  l_i = sum_j 2^(x_ij - m_i)
    P[b, i, j] = 2^(x_ij - m_i) / l_i                       (the build)
    out[b, i] = mf[b, i] + gamma sum_j P[b, i, j] v[b, j]   (the aggregation)

that is `softmax(q k^T / sqrt(DIM)) @ v`, scaled by gamma and added to mf,
every sum and statistic in f32.  This module:

  * `attention_build(qk)` makes P and the row statistics for one solve
    (`attention_buffers`: `flow.attention_made` counts each, and
    `flow.attention_bytes` adds their bytes; under a CUDA graph's capture
    they come from the graph's pool, so a replay makes none) and fills
    them: for CUDA tensors always through the CUDA kernels, P in bf16 (q
    and k rounded to bf16 first); for CPU tensors by the plain twin
    `build_plain`, P in bf16 for a bf16 solve, in f32 for an f32 one (the
    CPU tests' comparison with the float32 reference);
  * `attention_aggregate(probs, v, mf, gamma)` reads it: bf16 P through
    the CUDA kernel (v rounded to bf16) or its twin, f32 P by the plain
    function; out in mf's dtype;
  * `launches["attention_build"]` and `["attention_aggregate"]` count the
    CUDA calls (a build is two launches: the statistics, then P).

The twin repeats the kernels' arithmetic (bf16 products exact in f32, the
same exponent), so they differ only in the order of the f32 sums, and the
rows' sums l by it in their last bits: P within a bf16 rounding step where
that order tips it.  CPU tests and the on-card comparison use it; nothing
on the main path does when the tensors are on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ...utils import trace

DIM = 128                 # GMA's dim_head, one head
KEY_TILE = 64             # P's row stride is N rounded up to this (the kernels' key tile)
LOG2E = 1.4426950408889634
SCALE = LOG2E / math.sqrt(DIM)

launches = {"attention_build": 0, "attention_aggregate": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def padded_keys(N: int) -> int:
    return -(-N // KEY_TILE) * KEY_TILE


def attention_buffers(B: int, N: int, dtype, device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """P (B, N, cols) in `dtype` and the row statistics (B, N, 2) f32 of a
    solve, new on `device`; cols is N rounded up to `KEY_TILE` for bf16 P
    (the kernels' layout, the padding zeroed by the build), N for f32."""
    cols = padded_keys(N) if dtype == torch.bfloat16 else N
    probs = torch.empty((B, N, cols), dtype=dtype, device=device)
    stats = torch.empty((B, N, 2), dtype=torch.float32, device=device)
    trace.count("flow.attention_made")
    trace.count("flow.attention_bytes",
                probs.numel() * probs.element_size() + stats.numel() * 4)
    return probs, stats


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def build_plain(qk: torch.Tensor, probs: torch.Tensor, stats: torch.Tensor,
                rows: int = 1024) -> None:
    """qk (B, N, 2 DIM) in any float dtype -> probs (B, N, cols) in its
    dtype (bf16: the kernels' rounding; f32: none; columns past N zero) and
    stats (B, N, 2) f32 = (m, 1 / l), in place; `rows` rows at a time."""
    B, N, _ = qk.shape
    q, k = qk[..., :DIM].float(), qk[..., DIM:].float()
    probs[..., N:].zero_()
    for b in range(B):
        kt = k[b].transpose(0, 1)
        for s in range(0, N, rows):
            x = torch.matmul(q[b, s:s + rows], kt) * SCALE
            m = x.amax(dim=-1, keepdim=True)
            p = torch.exp2(x - m)
            inv = 1.0 / p.sum(dim=-1, keepdim=True)
            probs[b, s:s + rows, :N] = (p * inv).to(probs.dtype)
            stats[b, s:s + rows, 0] = m[:, 0]
            stats[b, s:s + rows, 1] = inv[:, 0]


def aggregate_plain(probs: torch.Tensor, v: torch.Tensor, mf: torch.Tensor,
                    gamma: torch.Tensor, rows: int = 4096) -> torch.Tensor:
    """mf + gamma (probs @ v), every product and sum in f32, in mf's dtype;
    probs (B, N, cols), v and mf (B, N, DIM)."""
    B, N, _ = mf.shape
    out = torch.empty_like(mf)
    vf, g = v.float(), gamma.float()
    for s in range(0, N, rows):
        acc = torch.matmul(probs[:, s:s + rows, :N].float(), vf)
        out[:, s:s + rows] = (mf[:, s:s + rows].float() + g * acc).to(mf.dtype)
    return out


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _library():
    from .build import load

    lib = load("gma_attention")
    if not getattr(lib, "_deflicker_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gma_attention_build.argtypes = [P, I, I, I, I, F, P, P, P]
        lib.gma_attention_build.restype = I
        lib.gma_attention_aggregate.argtypes = [P, P, P, P, P, I, I, I, I, P]
        lib.gma_attention_aggregate.restype = I
        lib._deflicker_typed = True
    return lib


def _need(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def build_cuda(qk: torch.Tensor, probs: torch.Tensor, stats: torch.Tensor) -> None:
    """The build's two launches: qk (B, N, 2 DIM) bf16 on a CUDA device,
    rows contiguous with a stride that is a multiple of 8; probs (B, N,
    padded_keys(N)) bf16 and stats (B, N, 2) f32, contiguous there."""
    if not qk.is_cuda:
        raise ValueError("the CUDA attention kernels need CUDA tensors")
    B, N, C = qk.shape
    if C != 2 * DIM or qk.dtype != torch.bfloat16 or qk.stride(2) != 1 \
            or qk.stride(1) % 8 or qk.stride(0) != N * qk.stride(1) or qk.data_ptr() % 16:
        raise ValueError(f"qk must be bf16 (B, N, {2 * DIM}) rows with a stride that is "
                         f"a multiple of 8, got {qk.dtype} {tuple(qk.shape)} "
                         f"strides {qk.stride()}")
    _need("probs", probs, torch.bfloat16, (B, N, padded_keys(N)), qk.device)
    _need("stats", stats, torch.float32, (B, N, 2), qk.device)
    if B * N == 0:
        return
    with torch.cuda.device(qk.device):
        err = _library().gma_attention_build(
            qk.data_ptr(), qk.stride(1), B, N, padded_keys(N), SCALE, stats.data_ptr(),
            probs.data_ptr(), torch.cuda.current_stream(qk.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gma_attention_build failed: CUDA error {err}")
    launches["attention_build"] += 1


def aggregate_cuda(probs: torch.Tensor, v: torch.Tensor, mf: torch.Tensor,
                   gamma: torch.Tensor) -> torch.Tensor:
    """The aggregation's launch: probs (B, N, padded_keys(N)) and v (B, N,
    DIM) bf16, mf (B, N, DIM) and gamma (one value) bf16 or f32, all
    contiguous on one CUDA device -> out like mf."""
    if not probs.is_cuda:
        raise ValueError("the CUDA attention kernels need CUDA tensors")
    B, N, _ = mf.shape
    dev = probs.device
    _need("probs", probs, torch.bfloat16, (B, N, padded_keys(N)), dev)
    _need("v", v, torch.bfloat16, (B, N, DIM), dev)
    if mf.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mf must be bf16 or f32, got {mf.dtype}")
    _need("mf", mf, mf.dtype, (B, N, DIM), dev)
    if gamma.dtype != mf.dtype or gamma.numel() != 1 or gamma.device != dev:
        raise ValueError(f"gamma must be one {mf.dtype} value on {dev}")
    out = torch.empty_like(mf)
    if B * N == 0:
        return out
    with torch.cuda.device(dev):
        err = _library().gma_attention_aggregate(
            probs.data_ptr(), v.data_ptr(), mf.data_ptr(), gamma.data_ptr(), out.data_ptr(),
            B, N, padded_keys(N), int(mf.dtype == torch.float32),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gma_attention_aggregate failed: CUDA error {err}")
    launches["attention_aggregate"] += 1
    return out


# ---------------------------------------------------------------------------
# the solve's entry points
# ---------------------------------------------------------------------------

def attention_build(qk: torch.Tensor) -> torch.Tensor:
    """P of qk (B, N, 2 DIM), new for this solve (see the module
    docstring).  Returns P."""
    B, N, _ = qk.shape
    if qk.is_cuda:
        probs, stats = attention_buffers(B, N, torch.bfloat16, qk.device)
        build_cuda(qk.to(torch.bfloat16).contiguous(), probs, stats)
        return probs
    dtype = torch.float32 if qk.dtype == torch.float32 else torch.bfloat16
    probs, stats = attention_buffers(B, N, dtype, qk.device)
    build_plain(qk.to(dtype), probs, stats)
    return probs


def attention_aggregate(probs: torch.Tensor, v: torch.Tensor, mf: torch.Tensor,
                        gamma: torch.Tensor) -> torch.Tensor:
    """mf + gamma (P @ v) (see the module docstring), in mf's dtype."""
    if probs.dtype == torch.bfloat16:
        v = v.to(torch.bfloat16)
        if probs.is_cuda:
            return aggregate_cuda(probs, v.contiguous(), mf.contiguous(),
                                  gamma.to(mf.dtype))
    return aggregate_plain(probs, v, mf, gamma)
