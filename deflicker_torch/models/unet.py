"""Stage-2 neural filter: the 4-level U-Net as an nn.Module (NCHW inside).

The reference UNet (src/models/network_filter.py:8-110): double-3x3-conv
blocks WITHOUT norm layers (the reference comments them out) and without
bias on block convs; 2x2 max-pool downs; align-corners bilinear x2 upsample
+ 3x3 conv ups; 1x1 output conv.  Pipeline instantiation: in=6 (content ⊕
atlas frame), out=3, features=32.  Module names are the reference's
state-dict keys (`encoder1.enc1conv1`, `upconv4.1`, ...), so the JAX
package's converted weights map by name (utils/convert.stage2_from_flax).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convex_upsample import resize_bilinear_align_corners
from .flax_init import init_like_flax_


class _Block(nn.Module):
    def __init__(self, in_ch: int, features: int, prefix: str):
        super().__init__()
        self.prefix = prefix
        self.add_module(f"{prefix}conv1",
                        nn.Conv2d(in_ch, features, 3, padding=1, bias=False))
        self.add_module(f"{prefix}conv2",
                        nn.Conv2d(features, features, 3, padding=1, bias=False))

    def forward(self, x):
        x = F.relu(getattr(self, f"{self.prefix}conv1")(x))
        return F.relu(getattr(self, f"{self.prefix}conv2")(x))


class _UpAlignCorners(nn.Module):
    """x2 bilinear align-corners upsample (the reference's nn.Upsample at
    Sequential index 0), through the ported resize op."""

    def forward(self, x):
        N, C, H, W = x.shape
        y = resize_bilinear_align_corners(x.permute(0, 2, 3, 1), 2 * H, 2 * W)
        return y.permute(0, 3, 1, 2)


def _upconv(in_ch: int, out_ch: int) -> nn.Sequential:
    return nn.Sequential(_UpAlignCorners(),
                         nn.Conv2d(in_ch, out_ch, 3, padding=1))


class UNet(nn.Module):
    def __init__(self, in_channels: int = 6, out_channels: int = 3,
                 features: int = 32):
        super().__init__()
        f = features
        self.encoder1 = _Block(in_channels, f, "enc1")
        self.encoder2 = _Block(f, f * 2, "enc2")
        self.encoder3 = _Block(f * 2, f * 4, "enc3")
        self.encoder4 = _Block(f * 4, f * 8, "enc4")
        self.bottleneck = _Block(f * 8, f * 16, "bottleneck")
        self.upconv4 = _upconv(f * 16, f * 8)
        self.decoder4 = _Block(f * 16, f * 8, "dec4")
        self.upconv3 = _upconv(f * 8, f * 4)
        self.decoder3 = _Block(f * 8, f * 4, "dec3")
        self.upconv2 = _upconv(f * 4, f * 2)
        self.decoder2 = _Block(f * 4, f * 2, "dec2")
        self.upconv1 = _upconv(f * 2, f)
        self.decoder1 = _Block(f * 2, f, "dec1")
        self.conv = nn.Conv2d(f, out_channels, 1)

    @staticmethod
    def _up(seq: nn.Sequential, z: torch.Tensor) -> torch.Tensor:
        # the resize promotes a bf16 input to f32; the conv runs in the
        # module's dtype (as the JAX package casts before its conv)
        conv = seq[1]
        return conv(seq[0](z).to(conv.weight.dtype))

    def forward(self, x):
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(F.max_pool2d(enc1, 2, 2))
        enc3 = self.encoder3(F.max_pool2d(enc2, 2, 2))
        enc4 = self.encoder4(F.max_pool2d(enc3, 2, 2))
        bott = self.bottleneck(F.max_pool2d(enc4, 2, 2))
        dec4 = self.decoder4(torch.cat([self._up(self.upconv4, bott), enc4], 1))
        dec3 = self.decoder3(torch.cat([self._up(self.upconv3, dec4), enc3], 1))
        dec2 = self.decoder2(torch.cat([self._up(self.upconv2, dec3), enc2], 1))
        dec1 = self.decoder1(torch.cat([self._up(self.upconv1, dec2), enc1], 1))
        return self.conv(dec1)


def unet_init(generator: torch.Generator, in_channels: int = 6,
              out_channels: int = 3, features: int = 32) -> UNet:
    """A UNet initialized as flax initializes the JAX package's
    (`models/flax_init.py`), from `generator`."""
    with torch.random.fork_rng(devices=[]):     # leave the global stream
        net = UNet(in_channels, out_channels, features)
    return init_like_flax_(net, generator)
