"""RAFT optical flow in PyTorch (the JAX package's `models/raft.py`).

The reference RAFT stack (src/models/stage_1/core/{raft,extractor,update,
corr}.py), full-size test-mode path only: fnet with instance norm, cnet with
batch norm on running stats, hidden = context = 128, a 4-level correlation
pyramid of radius 4, the SepConvGRU update block iterated in a Python loop,
and the convex-upsampling mask head run once on the final GRU state (the
reference computes it every iteration and keeps the last; the result is the
same).

Submodules carry the reference's state-dict names (`fnet.layer1.0.conv1`,
`cnet.layer2.0.downsample.0/.1`, `update_block.mask.0/.2`), so a
`raft-things.pth` state dict loads with `load_state_dict(strict=True)` once
its `module.` prefix is stripped (flow/convert.py).

Layout follows the JAX package at every public function: images, feature
maps, coords and flow are (B, H, W, C), coords and flow are (x, y).  The
encoders and the update block take and return NHWC and view it as NCHW
(channels-last strides, no copy) around their convolutions.

Precision: the convs and the GRU run in the dtype of the module's parameters
(bfloat16 mirrors the reference's autocast regions); feature maps, the
correlation and the flow arithmetic are float32.

Quirk kept for checkpoint parity (corr.py:42-47): the 81 window channels
enumerate the X offset on the OUTER axis — channel p*(2r+1)+q samples
(x + off[p], y + off[q]).

The correlation lookup has four modes (`raft_flow`): the materialized
all-pairs volume, the online gather, the hand-written CUDA kernel
(ops/cuda/corr_kernel.py) and `auto`.  Multi-GPU sharding of the pair batch
is not part of this module.  GMA (models/gma.py) is RAFT with a wider GRU
and an attention over the context features; `raft_flow` solves both.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convex_upsample import convex_upsample_flow
from ..ops.coords import coords_grid
from ..ops.cuda.corr_kernel import (corr_lookup_cuda, corr_lookup_plain,
                                   select_body)
from ..utils.device import set_fp32_matmul_precision

CORR_LEVELS = 4
CORR_RADIUS = 4
HIDDEN_DIM = 128
CONTEXT_DIM = 128


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _make_norm(kind: str, planes: int) -> nn.Module:
    """'instance': per-(sample, channel) statistics over H, W, biased
    variance, eps 1e-5, no parameters.  'batch': batch norm that always
    runs on its running statistics (the module stays in eval mode)."""
    if kind == "instance":
        return nn.InstanceNorm2d(planes)
    if kind == "batch":
        return nn.BatchNorm2d(planes)
    raise ValueError(f"unsupported norm kind: {kind}")


class ResidualBlock(nn.Module):
    """extractor.py:6-57: 3x3-3x3 residual block with an optional strided
    1x1 downsample path.  As in the reference, `norm3` is also entry 1 of
    the `downsample` Sequential, so a batch-norm block lists its parameters
    under both names."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _make_norm(norm_fn, planes)
        self.norm2 = _make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = _make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):                                   # NCHW
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """extractor.py:118-192: 7x7/2 stem, six residual blocks, 1x1 head;
    (B, H, W, 3) -> (B, H/8, W/8, output_dim)."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _make_norm(norm_fn, 64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm_fn, 1),
                                    ResidualBlock(64, 64, norm_fn, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm_fn, 2),
                                    ResidualBlock(96, 96, norm_fn, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm_fn, 2),
                                    ResidualBlock(128, 128, norm_fn, 1))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):                                   # NHWC
        x = F.relu(self.norm1(self.conv1(_nchw(x))))
        x = self.layer3(self.layer2(self.layer1(x)))
        return _nhwc(self.conv2(x))


class BasicMotionEncoder(nn.Module):
    """update.py:79-97."""

    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):                          # NCHW
        cor = F.relu(self.convc1(corr))
        cor = F.relu(self.convc2(cor))
        flo = F.relu(self.convf1(flow))
        flo = F.relu(self.convf2(flo))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """update.py:33-60: separable (1,5) then (5,1) gated GRU."""

    def __init__(self, hidden_dim: int = HIDDEN_DIM,
                 input_dim: int = HIDDEN_DIM + CONTEXT_DIM):
        super().__init__()
        c = hidden_dim + input_dim
        for suffix, kern, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{suffix}",
                        nn.Conv2d(c, hidden_dim, kern, padding=pad))

    def forward(self, h, x):                                # NCHW
        for suffix in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            q = torch.tanh(getattr(self, f"convq{suffix}")(
                torch.cat([r * h, x], dim=1)))
            h = (1.0 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    """update.py:6-14."""

    def __init__(self, input_dim: int = HIDDEN_DIM, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x):                                   # NCHW
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    """update.py:114-139, with the mask head apart from the step so
    `raft_flow` runs it once, on the final GRU state.  NHWC in and out.
    `gru_input` is the GRU's input width (RAFT's context and motion
    features; GMA adds the aggregated motion, models/gma.py)."""

    def __init__(self, corr_levels: int = CORR_LEVELS,
                 corr_radius: int = CORR_RADIUS,
                 gru_input: int = CONTEXT_DIM + HIDDEN_DIM):
        super().__init__()
        self.encoder = BasicMotionEncoder(
            corr_levels * (2 * corr_radius + 1) ** 2)
        self.gru = SepConvGRU(HIDDEN_DIM, gru_input)
        self.flow_head = FlowHead(HIDDEN_DIM, 256)
        self.mask = nn.Sequential(nn.Conv2d(HIDDEN_DIM, 256, 3, padding=1),
                                  nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        """One GRU step: (net, inp, corr, flow) -> (net, delta_flow)."""
        motion = self.encoder(_nchw(flow), _nchw(corr))
        net = self.gru(_nchw(net), torch.cat([_nchw(inp), motion], dim=1))
        return _nhwc(net), _nhwc(self.flow_head(net))

    def mask_head(self, net):
        # ".25 * mask to balance gradients" (update.py:136-137)
        return 0.25 * _nhwc(self.mask(_nchw(net)))


class RAFT(nn.Module):
    """The three learned components (raft.py:58-60, full-size config).  The
    flow solve is `raft_flow`; the module stays in eval mode.  `NAME` names
    the model in the flow engine's graph keys and messages."""

    NAME = "RAFT"

    def __init__(self, update_block: Optional[nn.Module] = None):
        super().__init__()
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(HIDDEN_DIM + CONTEXT_DIM, "batch")
        self.update_block = (BasicUpdateBlock() if update_block is None
                             else update_block)
        self.eval()

    def train(self, mode: bool = True):
        if mode:
            raise RuntimeError(f"{self.NAME} is inference only here: batch "
                               "norm always runs on its running statistics")
        return super().train(False)

    def update_step(self, inp: torch.Tensor):
        """The GRU step of one solve, `(net, inp, corr, flow) -> (net,
        delta)`, given the context features `inp`: RAFT's update block.
        (GMA builds its attention here, models/gma.py.)"""
        return self.update_block


# ---------------------------------------------------------------------------
# correlation pyramid (functional)
# ---------------------------------------------------------------------------

def _halve(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool over dims 1, 2 of (N, H, W, ...), floor semantics (an
    odd trailing row or column is dropped); a level may come out empty."""
    h2, w2 = (x.shape[1] // 2) * 2, (x.shape[2] // 2) * 2
    x = x[:, :h2, :w2]
    return x.reshape(x.shape[0], h2 // 2, 2, w2 // 2, 2,
                     *x.shape[3:]).mean(dim=(2, 4))


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = CORR_LEVELS) -> List[torch.Tensor]:
    """All-pairs correlation + mean-pool pyramid (corr.py:16-31,56-64).
    fmap1/fmap2: (B, H, W, D) float32.  Returns [(B*H*W, H_l, W_l)]."""
    B, H, W, D = fmap1.shape
    corr = torch.matmul(fmap1.reshape(B, H * W, D).float(),
                        fmap2.reshape(B, H * W, D).float().transpose(1, 2))
    corr = (corr / math.sqrt(D)).reshape(B * H * W, H, W)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        pyramid.append(_halve(pyramid[-1]))
    return pyramid


def _bilinear_gather(vol: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor) -> torch.Tensor:
    """vol: (N, H, W); xs/ys: (N, K) pixel coords.  Zeros outside."""
    N, H, W = vol.shape
    if H * W == 0:
        return torch.zeros_like(xs)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = xs - x0
    wy = ys - y0
    x0i = x0.long()
    y0i = y0.long()
    flat = vol.reshape(N, H * W)

    def g(iy, ix):
        valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        return torch.where(valid, torch.gather(flat, 1, idx), 0.0)

    v00 = g(y0i, x0i)
    v01 = g(y0i, x0i + 1)
    v10 = g(y0i + 1, x0i)
    v11 = g(y0i + 1, x0i + 1)
    return ((v00 * (1 - wx) + v01 * wx) * (1 - wy)
            + (v10 * (1 - wx) + v11 * wx) * wy)


def corr_lookup(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int = CORR_RADIUS) -> torch.Tensor:
    """Sample the (2r+1)^2 window around per-pixel coords at every level of
    a materialized pyramid (corr.py:33-54).  coords: (B, H, W, 2) (x, y).
    Returns (B, H, W, levels*(2r+1)^2) float32, x offset outer."""
    B, H, W, _ = coords.shape
    N = B * H * W
    K = 2 * radius + 1
    off = torch.arange(-radius, radius + 1, dtype=torch.float32,
                       device=coords.device)
    off_x = off.repeat_interleave(K)        # outer axis: x offset
    off_y = off.repeat(K)                   # inner axis: y offset
    cx = coords[..., 0].reshape(N, 1)
    cy = coords[..., 1].reshape(N, 1)
    out = []
    for i, vol in enumerate(pyramid):
        xs = cx / (2.0 ** i) + off_x[None, :]
        ys = cy / (2.0 ** i) + off_y[None, :]
        out.append(_bilinear_gather(vol, xs, ys))
    return torch.cat(out, dim=-1).reshape(B, H, W, len(pyramid) * K * K)


def build_fmap_pyramid(fmap2: torch.Tensor,
                       num_levels: int = CORR_LEVELS) -> List[torch.Tensor]:
    """Mean-pool pyramid of fmap2, [(B, H_l, W_l, D)], for the online and
    kernel paths: pooling features then dotting equals pooling the
    correlation volume (linearity), so the (H*W)^2 volume is never built."""
    pyr = [fmap2]
    for _ in range(num_levels - 1):
        pyr.append(_halve(pyr[-1]))
    return pyr


def corr_lookup_online(fmap1: torch.Tensor,
                       fmap2_pyramid: Sequence[torch.Tensor],
                       coords: torch.Tensor, radius: int = CORR_RADIUS,
                       chunk: int = 2048) -> torch.Tensor:
    """Window correlation on the fly from a float32 feature pyramid, by
    gathers in pixel chunks: same values and channel order as
    `build_corr_pyramid` + `corr_lookup`, O(chunk) live memory."""
    return corr_lookup_plain(fmap1, fmap2_pyramid, coords, radius, chunk)


# ---------------------------------------------------------------------------
# flow solve
# ---------------------------------------------------------------------------

def _select_corr_mode(corr_mode: str, device: torch.device, B: int,
                      n_pix: int) -> str:
    if corr_mode == "auto":
        if device.type == "cuda":
            return "kernel"
        volume_bytes = B * n_pix * n_pix * 4 * 1.34      # pyramid ~ 4/3 level 0
        return "online" if volume_bytes > 2e9 else "materialized"
    if corr_mode not in ("materialized", "online", "kernel"):
        raise ValueError(f"unknown corr_mode: {corr_mode}")
    return corr_mode


@torch.no_grad()
def raft_flow(model: RAFT, image1: torch.Tensor, image2: torch.Tensor,
              iters: int = 20, dtype=torch.float32, corr_mode: str = "auto"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimate flow image1 -> image2 (raft.py:93-146, test-mode semantics).

    image1/image2: (B, H, W, 3) in [0, 255] (uint8 or float), H and W
    divisible by 8, on the model's device.  `model` holds its parameters in
    `dtype` (`model.to(dtype)`).  Returns (flow_low (B, H/8, W/8, 2),
    flow_up (B, H, W, 2)), float32.

    corr_mode: 'materialized' = all-pairs volume + pyramid; 'online' =
    window correlation on the fly by gathers from an f32 feature pyramid;
    'kernel' = the same from a bf16-stored pyramid through the CUDA kernel,
    in the body DEFLICKER_CORR_SHARED / DEFLICKER_CORR_RESIDENT select (its
    plain twin for CPU tensors); 'auto' = the kernel on a CUDA device,
    and on the CPU materialized while the pyramid stays under ~2 GB, else
    online.

    `model` is a RAFT or a GMA (models/gma.py): after the context network
    `model.update_step` gives the GRU step of the solve, GMA's with its
    attention built once from the context features (on a CUDA device
    through the attention kernels in every correlation mode).
    """
    p_dtype = model.fnet.conv1.weight.dtype
    if p_dtype != dtype:
        raise ValueError(f"model parameters are {p_dtype}, asked for {dtype}: "
                         "convert the model with model.to(dtype) first")
    if image1.shape != image2.shape or image1.shape[1] % 8 or image1.shape[2] % 8:
        raise ValueError(f"images must share a shape with H, W divisible by "
                         f"8, got {tuple(image1.shape)} {tuple(image2.shape)}")
    set_fp32_matmul_precision()
    im1 = (2.0 * (image1.float() / 255.0) - 1.0).to(dtype)
    im2 = (2.0 * (image2.float() / 255.0) - 1.0).to(dtype)

    # both images in one fnet batch (extractor.py:170-191); instance norm is
    # per sample, so this changes nothing
    B = im1.shape[0]
    fmaps = model.fnet(torch.cat([im1, im2], dim=0)).float()
    fmap1, fmap2 = fmaps[:B].contiguous(), fmaps[B:].contiguous()
    _, H8, W8, _ = fmap1.shape

    mode = _select_corr_mode(corr_mode, fmap1.device, B, H8 * W8)
    if mode == "materialized":
        pyramid = build_corr_pyramid(fmap1, fmap2)
        lookup = lambda coords: corr_lookup(pyramid, coords)
    elif mode == "kernel":
        # f2 is pooled in f32 and rounded to bf16 once per solve; f1 and the
        # sums stay f32
        stored = [lvl.to(torch.bfloat16).contiguous()
                  for lvl in build_fmap_pyramid(fmap2)]
        if fmap1.is_cuda:
            # the body switches are read once per solve; every body computes
            # the plain twin's function, so the CPU path is the twin for all
            body = select_body()
            lookup = lambda coords: corr_lookup_cuda(
                fmap1, stored, coords.contiguous(), body=body)
        else:
            lookup = lambda coords: corr_lookup_plain(fmap1, stored, coords)
    else:
        fpyr = build_fmap_pyramid(fmap2)
        lookup = lambda coords: corr_lookup_online(fmap1, fpyr, coords)

    cnet = model.cnet(im1)
    net = torch.tanh(cnet[..., :HIDDEN_DIM])
    inp = F.relu(cnet[..., HIDDEN_DIM:])
    step = model.update_step(inp)

    coords0 = coords_grid(H8, W8, device=fmap1.device)[None].expand(
        B, H8, W8, 2)
    coords1 = coords0.clone()
    for _ in range(iters):
        corr = lookup(coords1)
        flow = coords1 - coords0
        net, delta = step(net, inp, corr.to(dtype), flow.to(dtype))
        coords1 = coords1 + delta.float()

    flow_low = coords1 - coords0
    up_mask = model.update_block.mask_head(net)
    flow_up = convex_upsample_flow(flow_low, up_mask.float(), factor=8)
    return flow_low, flow_up


def raft_init(generator: Optional[torch.Generator] = None,
              device="cpu") -> RAFT:
    """A RAFT with random weights drawn from `generator` on the CPU (so a
    seed gives the same weights on every device): conv kernels normal with
    std 1/sqrt(fan_in), biases 0, batch norms at scale 1, bias 0, mean 0,
    var 1."""
    model = RAFT()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / math.sqrt(fan_in))
                m.bias.zero_()
    return model.to(device)
