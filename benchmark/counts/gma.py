"""GMA's work, counted from the published architecture's shapes: RAFT's
(`counts/raft.py`: the encoders, the update block, the lookups' window
dots, the upsampling) plus what GMA adds to a flow direction.

Model FLOPs of one direction add: the attention's projection `to_qk` (128
-> 256, once), its build (q k^T over all N = H/8 W/8 positions, 2 N^2 128,
once), and every iteration the aggregation (attn @ v, 2 N^2 128), `to_v`
(128 -> 128) and the GRU's wider input (its six convs read 128 more
channels).  The softmax's exponentials are not counted, as no
elementwise work is.

The attention's bound (`attention_bound_s`) counts the same work whatever
implements it: one q k^T and `iters` products attn @ v a direction on the
tensor cores, against the bytes of q, k, and each iteration's v and output
in bf16 over the HBM rate; nothing of the N^2 attention, which a kernel
may store or recompute.  The larger of the two.
"""

from __future__ import annotations

from ..reference.gma import DIM_HEAD, GRU_INPUT, HEADS
from ..reference.raft import CONTEXT, HIDDEN
from . import peaks, raft

needed_dots = raft.needed_dots
lookup_bound_s = raft.lookup_bound_s

RAFT_GRU_INPUT = CONTEXT + HIDDEN
GRU_CONVS = 6           # z, r, q of the (1, 5) and the (5, 1) half
GRU_TAPS = 5


def attention_flops(N: int) -> float:
    """One N x N x 128 product: q k^T, or attn @ v."""
    return 2.0 * N * N * HEADS * DIM_HEAD


def iteration_extra_flops(N: int) -> float:
    """What a GMA iteration adds to RAFT's: the aggregation, to_v and the
    GRU's wider input."""
    gru = GRU_CONVS * 2.0 * (GRU_INPUT - RAFT_GRU_INPUT) * GRU_TAPS * HIDDEN * N
    to_v = 2.0 * HIDDEN * HEADS * DIM_HEAD * N
    return attention_flops(N) + to_v + gru


def direction_flops(H: int, W: int, iters: int) -> float:
    N = (H // 8) * (W // 8)
    to_qk = 2.0 * CONTEXT * 2 * HEADS * DIM_HEAD * N
    return (raft.direction_flops(H, W, iters) + to_qk + attention_flops(N)
            + iters * iteration_extra_flops(N))


def attention_bound_s(directions: int, H8: int, W8: int, iters: int) -> float:
    N = H8 * W8
    t_ops = directions * (1 + iters) * attention_flops(N) / peaks.BF16_FLOPS
    nbytes = directions * 2.0 * N * HEADS * DIM_HEAD * (2 + 2 * iters)
    return max(t_ops, nbytes / peaks.HBM_BYTES)
