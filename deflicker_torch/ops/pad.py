"""Divisibility padding for conv networks (NHWC), replicating edge pixels.

  * /8 'sintel': symmetric padding (RAFT);
  * /32 'other': width split left/right, height all at the bottom (stage 2,
    the reference's src/models/utils.py:626-645).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class Padder:
    def __init__(self, h: int, w: int, divisor: int = 8, mode: str = "sintel"):
        pad_h = (-h) % divisor
        pad_w = (-w) % divisor
        if mode == "sintel":
            self.top, self.bottom = pad_h // 2, pad_h - pad_h // 2
        else:  # 'other': all padding at the bottom
            self.top, self.bottom = 0, pad_h
        self.left, self.right = pad_w // 2, pad_w - pad_w // 2
        self.h, self.w = h, w

    @property
    def padded_hw(self):
        return (self.h + self.top + self.bottom, self.w + self.left + self.right)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C) -> padded along H, W with edge replication."""
        if not (self.top or self.bottom or self.left or self.right):
            return x
        y = F.pad(x.permute(0, 3, 1, 2),
                  (self.left, self.right, self.top, self.bottom),
                  mode="replicate")
        return y.permute(0, 2, 3, 1)

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-3], x.shape[-2]
        return x[..., self.top:h - self.bottom, self.left:w - self.right, :]
