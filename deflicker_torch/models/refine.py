"""Stage-2 local refinement: TransformNet + ConvLSTM as nn.Modules (NCHW).

The reference's refinement net (src/models/network_local.py, from
fast_blind_video_consistency): nf=32, 5 residual blocks, nc_in=12, nc_out=3.
Quirks kept because the shipped weights were trained with them:
  * no norm layers: `if self.norm in ["BN" or "IN"]` evaluates as
    `in ["BN"]` (network_local.py:136,169), so with the pipeline's "IN" the
    InstanceNorm layers never run;
  * the ConvLSTM gets prev_state=None on every frame, so its state is zero
    each time: hidden = σ(o)·tanh(σ(i)·tanh(g)) of the gates conv on
    cat(input, zeros) — the zeros concat included, since the Gates weights
    expect the hidden channels;
  * reflection padding on every ConvLayer, nearest x2 upsampling,
    LeakyReLU(0.2), tanh output.
Module names are the reference's state-dict keys.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect") if p else x


class ConvLayer(nn.Module):
    """network_local.py:118-139 (reflection pad + conv)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1):
        super().__init__()
        self.pad = kernel_size // 2
        self.conv2d = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride)

    def forward(self, x):
        return self.conv2d(_reflect_pad(x, self.pad))


class UpsampleConvLayer(nn.Module):
    """network_local.py:142-166: nearest x2 upsample + reflection-pad conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 upsample: int = 2):
        super().__init__()
        self.upsample = upsample
        self.pad = kernel_size // 2
        self.conv2d = nn.Conv2d(in_ch, out_ch, kernel_size)

    def forward(self, x):
        if self.upsample and self.upsample > 1:
            x = F.interpolate(x, scale_factor=self.upsample, mode="nearest")
        return self.conv2d(_reflect_pad(x, self.pad))


class ResidualBlock(nn.Module):
    """network_local.py:169-190 (leaky-relu 3x3-3x3 residual)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = ConvLayer(channels, channels, 3)
        self.conv2 = ConvLayer(channels, channels, 3)

    def forward(self, x):
        y = F.leaky_relu(self.conv1(x), 0.2)
        return x + self.conv2(y)


class ConvLSTM(nn.Module):
    """network_local.py:7-53 under the pipeline's prev_state=None calls."""

    def __init__(self, input_size: int, hidden_size: int, kernel_size: int = 3):
        super().__init__()
        self.hidden_size = hidden_size
        self.Gates = nn.Conv2d(input_size + hidden_size, 4 * hidden_size,
                               kernel_size, padding=kernel_size // 2)

    def forward(self, x):
        N, _, H, W = x.shape
        zeros = torch.zeros((N, self.hidden_size, H, W), dtype=x.dtype,
                            device=x.device)
        gates = self.Gates(torch.cat([x, zeros], 1))
        i, r, o, g = torch.chunk(gates, 4, dim=1)
        cell = torch.sigmoid(i) * torch.tanh(g)       # prev_cell = 0
        return torch.sigmoid(o) * torch.tanh(cell)


class TransformNet(nn.Module):
    """network_local.py:56-114.  Input (N, 12, H, W) = cat(P_t, O_{t-1},
    P_t, P_{t-1}); output the tanh residual (N, 3, H, W)."""

    def __init__(self, nf: int = 32, blocks: int = 5, nc_in: int = 12,
                 nc_out: int = 3):
        super().__init__()
        half = nc_in // 2
        self.conv1a = ConvLayer(half, nf, 7)
        self.conv1b = ConvLayer(half, nf, 7)
        self.conv2a = ConvLayer(nf, nf * 2, 3, 2)
        self.conv2b = ConvLayer(nf, nf * 2, 3, 2)
        self.conv3 = ConvLayer(nf * 4, nf * 4, 3, 2)
        self.ResBlocks = nn.ModuleList(ResidualBlock(nf * 4)
                                       for _ in range(blocks))
        self.convlstm = ConvLSTM(nf * 4, nf * 4, 3)
        self.deconv1 = UpsampleConvLayer(nf * 4, nf * 2, 3)
        self.deconv2 = UpsampleConvLayer(nf * 4, nf, 3)
        self.deconv3 = ConvLayer(nf * 2, nc_out, 7)

    def forward(self, x):
        lrelu = lambda v: F.leaky_relu(v, 0.2)
        half = x.shape[1] // 2
        xa, xb = x[:, :half], x[:, half:]
        e1a = lrelu(self.conv1a(xa))
        e1b = lrelu(self.conv1b(xb))
        e2a = lrelu(self.conv2a(e1a))
        e2b = lrelu(self.conv2b(e1b))
        rb = lrelu(self.conv3(torch.cat([e2a, e2b], 1)))
        for block in self.ResBlocks:
            rb = block(rb)
        hidden = self.convlstm(rb)
        d2 = lrelu(self.deconv1(hidden))
        d1 = lrelu(self.deconv2(torch.cat([d2, e2a], 1)))
        y = self.deconv3(torch.cat([d1, e1a], 1))
        return torch.tanh(y)
