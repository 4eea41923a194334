"""GMA optical flow in PyTorch: RAFT with global motion aggregation.

Jiang, Campbell, Lu, Li and Hartley, "Learning to Estimate Hidden Motions
with Global Motion Aggregation", ICCV 2021 (zacjiang/GMA, `core/network.py`
`RAFTGMA`, `core/gma.py` `Attention` / `Aggregate`, `core/update.py`
`GMAUpdateBlock`), as released: one head, content only (neither
`--position_only` nor `--position_and_content`), test mode.  It is RAFT
(models/raft.py) with two additions:

  * once a solve, from the context net's input half `inp`, an attention
    over all N = H/8 W/8 positions: `q, k = to_qk(inp).chunk(2)` (a 1x1
    conv 128 -> 256, no bias), `attn = softmax(q k^T / sqrt(128))`;
  * every GRU iteration the motion features `mf` (RAFT's motion encoder)
    aggregated through it, `g = mf + gamma (attn @ to_v(mf))` (`to_v` a
    1x1 conv 128 -> 128, no bias; gamma a learned scalar, 0 at GMA's
    initialisation), and the GRU fed `cat(inp, mf, g)`: 384 channels
    against RAFT's 256, so its convs read 512 in each half.

Everything else is RAFT's modules as they are (the encoders, the motion
encoder, the flow head, the mask head run once on the final state) and
`raft_flow`'s solve, which asks the model for its update step
(`GMA.update_step`: the attention built there, in the span
`flow/attention`).

Submodules carry GMA's state-dict names (`att.to_qk`,
`update_block.aggregator.to_v`, `update_block.aggregator.gamma`, and
RAFT's), so a published `gma-*.pth` loads with `load_state_dict(strict=True)`
once its `module.` prefix is stripped (flow/convert.py picks GMA by the key
`att.to_qk.weight`).  The published `Attention` also builds relative
position tables (`att.pos_emb.rel_height`, `rel_width` and the index buffer
`rel_ind`) that the content-only path never reads; they are loaded here
and left unused likewise.

The attention runs through `ops/cuda/attention_kernel.py`: P made and
stored once a solve, bf16 products with f32 sums and f32 softmax
statistics, through the CUDA kernels on the card whatever the correlation
mode, and through their plain twin on the CPU (P in f32 there for an f32
solve).  Precision otherwise follows RAFT's: bf16 convolutions and GRU in
the parameters' dtype, f32 flow arithmetic.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn

from ..ops.cuda.attention_kernel import attention_aggregate, attention_build
from ..utils import trace
from .raft import (CONTEXT_DIM, HIDDEN_DIM, RAFT, BasicUpdateBlock, _nchw,
                   _nhwc)

HEADS = 1
DIM_HEAD = 128
MAX_POS_SIZE = 160          # network.py: Attention(..., max_pos_size=160)


class RelPosEmb(nn.Module):
    """gma.py `RelPosEmb`: relative position tables over a 160 x 160 grid.
    The content-only attention never reads them; they are here so that a
    published state dict loads strictly."""

    def __init__(self, max_pos_size: int = MAX_POS_SIZE, dim_head: int = DIM_HEAD):
        super().__init__()
        self.rel_height = nn.Embedding(2 * max_pos_size - 1, dim_head)
        self.rel_width = nn.Embedding(2 * max_pos_size - 1, dim_head)
        deltas = (torch.arange(max_pos_size).view(1, -1)
                  - torch.arange(max_pos_size).view(-1, 1))
        self.register_buffer("rel_ind", deltas + max_pos_size - 1)


class Attention(nn.Module):
    """gma.py `Attention`, content only, one head: the solve's attention
    over the context features (`forward`: its P)."""

    def __init__(self, dim: int = CONTEXT_DIM, heads: int = HEADS,
                 dim_head: int = DIM_HEAD, max_pos_size: int = MAX_POS_SIZE):
        super().__init__()
        if heads != 1 or dim_head != DIM_HEAD:
            raise ValueError("the attention kernels take one head of 128 channels")
        self.to_qk = nn.Conv2d(dim, 2 * heads * dim_head, 1, bias=False)
        self.pos_emb = RelPosEmb(max_pos_size, dim_head)

    def qk(self, inp: torch.Tensor) -> torch.Tensor:
        """(B, H, W, dim) context features -> (B, H, W, 2 dim_head): q, then k."""
        return _nhwc(self.to_qk(_nchw(inp)))

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        qk = self.qk(inp)
        B, H, W, C = qk.shape
        return attention_build(qk.reshape(B, H * W, C))


class Aggregate(nn.Module):
    """gma.py `Aggregate`, one head (no `project`: dim == inner_dim):
    `fmap + gamma (attn @ to_v(fmap))`."""

    def __init__(self, dim: int = HIDDEN_DIM, heads: int = HEADS,
                 dim_head: int = DIM_HEAD):
        super().__init__()
        self.to_v = nn.Conv2d(dim, heads * dim_head, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn: torch.Tensor, fmap: torch.Tensor) -> torch.Tensor:
        B, C, H, W = fmap.shape                             # NCHW
        v = _nhwc(self.to_v(fmap)).reshape(B, H * W, -1)
        mf = _nhwc(fmap).reshape(B, H * W, C)
        out = attention_aggregate(attn, v, mf, self.gamma)
        return _nchw(out.view(B, H, W, C))


class GMAUpdateBlock(BasicUpdateBlock):
    """update.py `GMAUpdateBlock`: RAFT's update block with the aggregated
    motion features as a third GRU input; the mask head, as RAFT's, apart
    from the step.  NHWC in and out."""

    def __init__(self):
        super().__init__(gru_input=CONTEXT_DIM + 2 * HIDDEN_DIM)
        self.aggregator = Aggregate(HIDDEN_DIM, HEADS, DIM_HEAD)

    def forward(self, net, inp, corr, flow, attention):
        """One GRU step: (net, inp, corr, flow, the solve's P) -> (net,
        delta_flow)."""
        motion = self.encoder(_nchw(flow), _nchw(corr))
        glob = self.aggregator(attention, motion)
        net = self.gru(_nchw(net), torch.cat([_nchw(inp), motion, glob], dim=1))
        return _nhwc(net), _nhwc(self.flow_head(net))


class GMA(RAFT):
    """network.py `RAFTGMA` (num_heads 1, content only): RAFT's encoders,
    GMA's update block and the attention.  The flow solve is `raft_flow`;
    the module stays in eval mode."""

    NAME = "GMA"

    def __init__(self):
        super().__init__(GMAUpdateBlock())
        self.att = Attention(CONTEXT_DIM, HEADS, DIM_HEAD, MAX_POS_SIZE)
        self.eval()

    def update_step(self, inp: torch.Tensor):
        """The solve's attention, built once from `inp` (the span
        `flow/attention`), bound into the update block's step."""
        with trace.span("flow/attention"):
            attention = self.att(inp)
        return functools.partial(self.update_block, attention=attention)


def gma_init(generator: Optional[torch.Generator] = None, device="cpu",
             gamma: float = 0.0) -> GMA:
    """A GMA with random weights drawn from `generator` on the CPU, as
    `raft_init` draws RAFT's (conv kernels normal with std 1/sqrt(fan_in),
    biases 0, batch norms at their initial statistics), the position tables
    normal, and `gamma` (GMA initialises it to 0, where the attention drops
    out of the result)."""
    model = GMA()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        model.update_block.aggregator.gamma.fill_(gamma)
    return model.to(device)
