"""Device selection shared by the entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  With no CUDA device and no explicit device this raises — the
    port never drops to the CPU unasked."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


def set_fp32_matmul_precision() -> None:
    """Full-precision f32 products and convolutions (no TF32) for the f32
    paths — pretrain, render, f32 stage 2 — as the JAX package asks for
    HIGHEST precision there."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def synchronize(device) -> None:
    """Wait for the work queued on `device`, so a stage's wall time covers
    it; nothing to wait for off CUDA."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
