"""The plain reference of GMA's flow: zacjiang/GMA's `core/network.py`
`RAFTGMA` in test mode as released (`--num_heads 1`, content only), in
plain PyTorch over a dict of tensors keyed by the published state-dict
names.  It is `reference/raft.py`'s RAFT (its encoders, the all-pairs
correlation pyramid sampled with `grid_sample`, the convex upsampling)
plus GMA's two parts (`core/gma.py`, `core/update.py` `GMAUpdateBlock`):

  * once a solve, `q, k = to_qk(inp).chunk(2)` from the context features
    `inp`, `attn = softmax(q k^T / sqrt(128))` over all H/8 W/8 positions,
    built whole;
  * every iteration `g = mf + gamma (attn @ to_v(mf))` from the motion
    features `mf`, and the GRU fed `cat(inp, mf, g)` (its convs read 512
    channels, against RAFT's 384).

Departures from `core/network.py`, none of which changes the result:
float32 everywhere with TF32 off (the published model runs under autocast
when `--mixed_precision` is given); every convolution is its im2col
product, `F.unfold` and one matmul (cuDNN's float32 algorithms without
TF32 took 4.3-5.2 s a direction at 1080p on an H100, the products 0.39 s,
their flows within 1e-4 px); the mask head runs once, on the final
GRU state (the published block computes it every iteration and the test
mode keeps the last); only the last iteration's upsampled flow is
computed; `q` is scaled after the product (`(q k^T) / sqrt(128)` for
`(q / sqrt(128)) k^T`); the relative position tables (`att.pos_emb`) are
in the weights but unread, as in the published content-only path.

`precision="fp8"` is the control, as in RAFT's reference: each
convolution's input and weight, q and k before their product, and the
attention and v before theirs, rounded to float8 e4m3 with a per-tensor
scale.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import raft
from .raft import CONTEXT, HIDDEN, _fp8

HEADS = 1
DIM_HEAD = 128
MAX_POS = 160                       # network.py: Attention(max_pos_size=160)
GRU_INPUT = CONTEXT + 2 * HIDDEN    # inp, mf, g


def parameter_shapes() -> List[Tuple[str, tuple, str]]:
    """(state-dict name, shape, kind) of every tensor of the published
    model: RAFT's (`reference/raft.py`), the GRU's convs at GMA's input
    width, and kind "qk_w" (the attention's projection), "conv_w" (to_v,
    no bias), "gamma", "pos_emb" (the unread tables) and "pos_index" (their
    index buffer)."""
    out = []
    for name, shape, kind in raft.parameter_shapes():
        if ".gru.conv" in name and kind == "conv_w":
            shape = (shape[0], HIDDEN + GRU_INPUT) + shape[2:]
        out.append((name, shape, kind))
    out += [("att.to_qk.weight", (2 * HEADS * DIM_HEAD, CONTEXT, 1, 1), "qk_w"),
            ("att.pos_emb.rel_height.weight", (2 * MAX_POS - 1, DIM_HEAD), "pos_emb"),
            ("att.pos_emb.rel_width.weight", (2 * MAX_POS - 1, DIM_HEAD), "pos_emb"),
            ("att.pos_emb.rel_ind", (MAX_POS, MAX_POS), "pos_index"),
            ("update_block.aggregator.to_v.weight", (HEADS * DIM_HEAD, HIDDEN, 1, 1),
             "conv_w"),
            ("update_block.aggregator.gamma", (1,), "gamma")]
    return out


def position_index() -> torch.Tensor:
    """gma.py `RelPosEmb.rel_ind`: delta + MAX_POS - 1 over a MAX_POS grid."""
    deltas = torch.arange(MAX_POS).view(1, -1) - torch.arange(MAX_POS).view(-1, 1)
    return deltas + MAX_POS - 1


class Model(raft.Model):
    """The published GMA over `weights` (name -> tensor, any float dtype;
    used as float32)."""

    def __init__(self, weights: Dict[str, torch.Tensor], precision: str = "f32"):
        super().__init__({k: v for k, v in weights.items() if v.is_floating_point()},
                         precision)

    def conv(self, x, name, stride=1, padding=0):
        """A convolution as its im2col product: `F.unfold`, then one float32
        matmul (the same sums as `F.conv2d`, in another order)."""
        w, b = self.w[name + ".weight"], self.w.get(name + ".bias")
        if self.precision == "fp8":
            x, w = _fp8(x), _fp8(w)
        B, _, H, W = x.shape
        O, _, kh, kw = w.shape
        ph, pw = (padding, padding) if isinstance(padding, int) else padding
        cols = F.unfold(x, (kh, kw), padding=(ph, pw), stride=stride)
        y = torch.matmul(w.reshape(O, -1), cols).reshape(
            B, O, (H + 2 * ph - kh) // stride + 1, (W + 2 * pw - kw) // stride + 1)
        return y if b is None else y + b.view(1, -1, 1, 1)

    def attention(self, inp):
        """softmax(q k^T / sqrt(128)) of the context features (B, 128, H, W):
        (B, N, N)."""
        qk = self.conv(inp, "att.to_qk")
        B, _, H, W = qk.shape
        q = qk[:, :DIM_HEAD].reshape(B, DIM_HEAD, H * W).transpose(1, 2)
        k = qk[:, DIM_HEAD:].reshape(B, DIM_HEAD, H * W)
        if self.precision == "fp8":
            q, k = _fp8(q), _fp8(k)
        attn = torch.softmax(torch.matmul(q, k) * DIM_HEAD ** -0.5, dim=-1)
        return _fp8(attn) if self.precision == "fp8" else attn

    def aggregate(self, attn, mf):
        """mf + gamma (attn @ to_v(mf)), mf (B, 128, H, W)."""
        v = self.conv(mf, "update_block.aggregator.to_v")
        B, C, H, W = v.shape
        v = v.reshape(B, C, H * W).transpose(1, 2)
        if self.precision == "fp8":
            v = _fp8(v)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, C, H, W)
        return mf + self.w["update_block.aggregator.gamma"] * out

    def update(self, net, inp, corr, flow, attn):
        u = "update_block."
        cor = F.relu(self.conv(corr, u + "encoder.convc1"))
        cor = F.relu(self.conv(cor, u + "encoder.convc2", 1, 1))
        flo = F.relu(self.conv(flow, u + "encoder.convf1", 1, 3))
        flo = F.relu(self.conv(flo, u + "encoder.convf2", 1, 1))
        out = F.relu(self.conv(torch.cat([cor, flo], 1), u + "encoder.conv", 1, 1))
        mf = torch.cat([out, flow], 1)
        x = torch.cat([inp, mf, self.aggregate(attn, mf)], 1)
        for s, pad in (("1", (0, 2)), ("2", (2, 0))):
            hx = torch.cat([net, x], 1)
            z = torch.sigmoid(self.conv(hx, f"{u}gru.convz{s}", 1, pad))
            r = torch.sigmoid(self.conv(hx, f"{u}gru.convr{s}", 1, pad))
            q = torch.tanh(self.conv(torch.cat([r * net, x], 1), f"{u}gru.convq{s}", 1, pad))
            net = (1 - z) * net + z * q
        delta = self.conv(F.relu(self.conv(net, u + "flow_head.conv1", 1, 1)),
                          u + "flow_head.conv2", 1, 1)
        return net, delta


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
        levels = raft._pyramid(fmaps[:B], fmaps[B:])
        del fmaps
        cnet = model.encoder(im1, "cnet", True)
        net, inp = torch.tanh(cnet[:, :HIDDEN]), F.relu(cnet[:, HIDDEN:])
        attn = model.attention(inp)
        H8, W8 = cnet.shape[-2:]
        ys, xs = torch.meshgrid(torch.arange(H8, device=cnet.device),
                                torch.arange(W8, device=cnet.device), indexing="ij")
        coords0 = torch.stack([xs, ys]).float()[None].expand(B, 2, H8, W8)
        coords1 = coords0.clone()
        for _ in range(iters):
            if trace is not None:
                trace.append(coords1.permute(0, 2, 3, 1).clone())
            corr = raft._lookup(levels, coords1)
            net, delta = model.update(net, inp, corr, coords1 - coords0, attn)
            coords1 = coords1 + delta
        up = raft._upsample(coords1 - coords0, model.mask(net))
        return up.permute(0, 2, 3, 1).contiguous()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

