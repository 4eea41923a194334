"""The plain reference of the flow stage: RAFT as princeton-vl/RAFT's
`core/raft.py` runs it in test mode (the full model: 256-channel features,
hidden and context 128, a 4-level all-pairs correlation pyramid of radius
4, the separable-convolution GRU, convex upsampling), in plain PyTorch
over a dict of tensors keyed by the published state-dict names.

Every convolution runs in float32 with TF32 off; the correlation volume is
built whole and sampled with `grid_sample`, as the published CorrBlock does.
`precision="fp8"` rounds each convolution's input and weight to float8 e4m3
with a per-tensor scale: the control that a path one precision below the
configuration's bfloat16 convolutions has to fail.

Images are (B, H, W, 3) levels in [0, 255], H and W divisible by 8; flows
come back (B, H, W, 2) as (x, y).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

FEATURES = 256
HIDDEN = 128
CONTEXT = 128
LEVELS = 4
RADIUS = 4


def _encoder(prefix: str, out_dim: int, batch_norm: bool):
    """(name, cin, cout, k, stride, scale of the output) of each conv of a
    BasicEncoder, and its batch-norm layers (name, channels)."""
    convs = [(f"{prefix}.conv1", 3, 64, (7, 7), 2, 2)]
    norms = [(f"{prefix}.norm1", 64)]
    cin = 64
    for layer, (planes, stride, scale) in enumerate(((64, 1, 2), (96, 2, 4),
                                                     (128, 2, 8)), start=1):
        for blk in range(2):
            s = stride if blk == 0 else 1
            p = f"{prefix}.layer{layer}.{blk}"
            convs += [(f"{p}.conv1", cin, planes, (3, 3), s, scale),
                      (f"{p}.conv2", planes, planes, (3, 3), 1, scale)]
            norms += [(f"{p}.norm1", planes), (f"{p}.norm2", planes)]
            if s != 1:
                convs.append((f"{p}.downsample.0", cin, planes, (1, 1), s, scale))
                norms += [(f"{p}.norm3", planes), (f"{p}.downsample.1", planes)]
            cin = planes
    convs.append((f"{prefix}.conv2", 128, out_dim, (1, 1), 1, 8))
    return convs, (norms if batch_norm else [])


UPDATE = [  # (name, cin, cout, kernel): once a GRU iteration, at 1/8 scale
    ("update_block.encoder.convc1", LEVELS * (2 * RADIUS + 1) ** 2, 256, (1, 1)),
    ("update_block.encoder.convc2", 256, 192, (3, 3)),
    ("update_block.encoder.convf1", 2, 128, (7, 7)),
    ("update_block.encoder.convf2", 128, 64, (3, 3)),
    ("update_block.encoder.conv", 64 + 192, 128 - 2, (3, 3)),
    *[(f"update_block.gru.conv{g}{s}", HIDDEN + HIDDEN + CONTEXT, HIDDEN, k)
      for s, k in (("1", (1, 5)), ("2", (5, 1))) for g in "zrq"],
    ("update_block.flow_head.conv1", HIDDEN, 256, (3, 3)),
    ("update_block.flow_head.conv2", 256, 2, (3, 3)),
]
MASK_HEAD = [("update_block.mask.0", HIDDEN, 256, (3, 3)),
             ("update_block.mask.2", 256, 64 * 9, (1, 1))]


def parameter_shapes() -> List[Tuple[str, tuple, str]]:
    """(state-dict name, shape, kind) of every tensor of the published
    model; kind is "conv_w", "conv_b", "bn_w", "bn_b", "bn_mean", "bn_var"
    or "bn_count"."""
    out = []
    fconvs, _ = _encoder("fnet", FEATURES, False)
    cconvs, cnorms = _encoder("cnet", HIDDEN + CONTEXT, True)
    convs = [(n, ci, co, k) for n, ci, co, k, _, _ in fconvs + cconvs]
    for name, cin, cout, k in convs + UPDATE + MASK_HEAD:
        out.append((f"{name}.weight", (cout, cin) + tuple(k), "conv_w"))
        out.append((f"{name}.bias", (cout,), "conv_b"))
    for name, c in cnorms:
        out += [(f"{name}.weight", (c,), "bn_w"), (f"{name}.bias", (c,), "bn_b"),
                (f"{name}.running_mean", (c,), "bn_mean"),
                (f"{name}.running_var", (c,), "bn_var"),
                (f"{name}.num_batches_tracked", (), "bn_count")]
    return out


def conv_plan(H: int, W: int) -> Iterator[Tuple[str, int, int, tuple, int, int, int]]:
    """(name, cin, cout, kernel, out height, out width, runs a direction)
    of every convolution of one flow direction at image size H x W and 20
    iterations (the GRU's count is filled in by the caller's iterations)."""
    for prefix, out_dim, images in (("fnet", FEATURES, 2),
                                    ("cnet", HIDDEN + CONTEXT, 1)):
        for name, cin, cout, k, _, scale in _encoder(prefix, out_dim, False)[0]:
            yield name, cin, cout, k, H // scale, W // scale, images
    for name, cin, cout, k in UPDATE:
        yield name, cin, cout, k, H // 8, W // 8, -1
    for name, cin, cout, k in MASK_HEAD:
        yield name, cin, cout, k, H // 8, W // 8, 1


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class Model:
    """The published RAFT over `weights` (name -> tensor, any float dtype;
    used as float32)."""

    def __init__(self, weights: Dict[str, torch.Tensor], precision: str = "f32"):
        self.w = {k: v.float() for k, v in weights.items()}
        self.precision = precision

    def conv(self, x, name, stride=1, padding=0):
        w, b = self.w[name + ".weight"], self.w[name + ".bias"]
        if self.precision == "fp8":
            x, w = _fp8(x), _fp8(w)
        return F.conv2d(x, w, b, stride=stride, padding=padding)

    def norm(self, x, name, batch_norm):
        if not batch_norm:
            return F.instance_norm(x, eps=1e-5)
        w = self.w
        return F.batch_norm(x, w[name + ".running_mean"], w[name + ".running_var"],
                            w[name + ".weight"], w[name + ".bias"], False, 0.0, 1e-5)

    def block(self, x, p, stride, bn):
        y = F.relu(self.norm(self.conv(x, p + ".conv1", stride, 1), p + ".norm1", bn))
        y = F.relu(self.norm(self.conv(y, p + ".conv2", 1, 1), p + ".norm2", bn))
        if stride != 1:
            x = self.norm(self.conv(x, p + ".downsample.0", stride, 0), p + ".norm3", bn)
        return F.relu(x + y)

    def encoder(self, x, prefix, bn):
        x = F.relu(self.norm(self.conv(x, prefix + ".conv1", 2, 3), prefix + ".norm1", bn))
        for layer, stride in ((1, 1), (2, 2), (3, 2)):
            x = self.block(x, f"{prefix}.layer{layer}.0", stride, bn)
            x = self.block(x, f"{prefix}.layer{layer}.1", 1, bn)
        return self.conv(x, prefix + ".conv2")

    def update(self, net, inp, corr, flow):
        u = "update_block."
        cor = F.relu(self.conv(corr, u + "encoder.convc1"))
        cor = F.relu(self.conv(cor, u + "encoder.convc2", 1, 1))
        flo = F.relu(self.conv(flow, u + "encoder.convf1", 1, 3))
        flo = F.relu(self.conv(flo, u + "encoder.convf2", 1, 1))
        out = F.relu(self.conv(torch.cat([cor, flo], 1), u + "encoder.conv", 1, 1))
        x = torch.cat([inp, out, flow], 1)
        for s, pad in (("1", (0, 2)), ("2", (2, 0))):
            hx = torch.cat([net, x], 1)
            z = torch.sigmoid(self.conv(hx, f"{u}gru.convz{s}", 1, pad))
            r = torch.sigmoid(self.conv(hx, f"{u}gru.convr{s}", 1, pad))
            q = torch.tanh(self.conv(torch.cat([r * net, x], 1), f"{u}gru.convq{s}", 1, pad))
            net = (1 - z) * net + z * q
        delta = self.conv(F.relu(self.conv(net, u + "flow_head.conv1", 1, 1)),
                          u + "flow_head.conv2", 1, 1)
        return net, delta

    def mask(self, net):
        m = F.relu(self.conv(net, "update_block.mask.0", 1, 1))
        return 0.25 * self.conv(m, "update_block.mask.2")


def _pyramid(f1, f2):
    """The all-pairs correlation of (B, D, H, W) features and its average
    pooled levels, each (B*H*W, 1, H_l, W_l)."""
    B, D, H, W = f1.shape
    corr = torch.matmul(f1.reshape(B, D, H * W).transpose(1, 2),
                        f2.reshape(B, D, H * W)) / math.sqrt(D)
    levels = [corr.reshape(B * H * W, 1, H, W)]
    for _ in range(LEVELS - 1):
        levels.append(F.avg_pool2d(levels[-1], 2, stride=2))
    return levels


def _lookup(levels, coords):
    """The (2r+1)^2 window of every level around coords (B, 2, H, W),
    bilinear with zeros outside; the x offset runs over the outer index."""
    B, _, H, W = coords.shape
    r = RADIUS
    d = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([dy, dx], -1).reshape(1, 2 * r + 1, 2 * r + 1, 2)
    c = coords.permute(0, 2, 3, 1).reshape(B * H * W, 1, 1, 2)
    out = []
    for l, corr in enumerate(levels):
        pts = c / 2 ** l + delta
        hl, wl = corr.shape[-2:]
        gx = 2 * pts[..., 0] / (wl - 1) - 1
        gy = 2 * pts[..., 1] / (hl - 1) - 1
        s = F.grid_sample(corr, torch.stack([gx, gy], -1), align_corners=True)
        out.append(s.reshape(B, H, W, -1))
    return torch.cat(out, -1).permute(0, 3, 1, 2).float()


def _upsample(flow, mask):
    N, _, H, W = flow.shape
    mask = torch.softmax(mask.view(N, 1, 9, 8, 8, H, W), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(N, 2, 9, 1, 1, H, W)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(N, 2, 8 * H, 8 * W)


@torch.no_grad()
def flow(model: Model, image1: torch.Tensor, image2: torch.Tensor,
         iters: int = 20, trace=None) -> torch.Tensor:
    """Flow image1 -> image2, (B, H, W, 2).  `trace`, a list, receives the
    coordinates (B, H/8, W/8, 2) each lookup reads."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        im1 = 2 * (image1.float().permute(0, 3, 1, 2) / 255.0) - 1
        im2 = 2 * (image2.float().permute(0, 3, 1, 2) / 255.0) - 1
        fmaps = model.encoder(torch.cat([im1, im2]), "fnet", False)
        B = im1.shape[0]
        levels = _pyramid(fmaps[:B], fmaps[B:])
        cnet = model.encoder(im1, "cnet", True)
        net, inp = torch.tanh(cnet[:, :HIDDEN]), F.relu(cnet[:, HIDDEN:])
        H8, W8 = cnet.shape[-2:]
        ys, xs = torch.meshgrid(torch.arange(H8, device=cnet.device),
                                torch.arange(W8, device=cnet.device), indexing="ij")
        coords0 = torch.stack([xs, ys]).float()[None].expand(B, 2, H8, W8)
        coords1 = coords0.clone()
        for _ in range(iters):
            if trace is not None:
                trace.append(coords1.permute(0, 2, 3, 1).clone())
            corr = _lookup(levels, coords1)
            net, delta = model.update(net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta
        up = _upsample(coords1 - coords0, model.mask(net))
        return up.permute(0, 2, 3, 1).contiguous()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
