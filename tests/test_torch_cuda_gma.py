"""GMA's attention kernels on the card against their plain twin, and GMA's
captured solve against the eager one.  Imports no JAX, so it also runs on
a machine without it:

    python -m pytest tests/test_torch_cuda_gma.py -q -m cuda --noconftest

Every test skips without a CUDA device (a CUDA kernel has no CPU mode)."""

import math

import numpy as np
import pytest
import torch

from deflicker_torch.models import raft as traft
from deflicker_torch.models.gma import gma_init
from deflicker_torch.ops.cuda import attention_kernel as A

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

# (B, H/8, W/8): a small grid, a ragged one (N = 351, not a multiple of 64
# or of 128), single-flow's and 1080p's
SHAPES = [(2, 8, 12), (3, 13, 27), (2, 54, 96), (1, 135, 240)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _qk(B, N, device, spread=3.0, seed=0):
    """q and k whose logits spread about `spread` (a peaked attention, as
    the flow cell's weights give)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, N, 2 * A.DIM), generator=gen) * math.sqrt(spread) / A.DIM ** 0.25
    return x.to(torch.bfloat16).to(device)


@pytest.mark.parametrize("shape", SHAPES)
def test_attention_kernels_match_the_twin(shape, cuda_device):
    """The build (statistics, then P) and the aggregation with bf16 and f32
    motion features, against the twin on the same card: the statistics
    within f32 rounding of the sums' order, P within one bf16 rounding
    step (where the sums' order tips a rounding), the output within bf16
    rounding of its own size (or f32's, for f32 mf); two calls bit-equal."""
    B, H8, W8 = shape
    N = H8 * W8
    qk = _qk(B, N, cuda_device)
    A.reset_launches()
    p, s = A.attention_buffers(B, N, torch.bfloat16, cuda_device)
    A.build_cuda(qk, p, s)
    pw, sw = A.attention_buffers(B, N, torch.bfloat16, cuda_device)
    A.build_plain(qk, pw, sw)
    torch.cuda.synchronize()
    assert A.launches["attention_build"] == 1
    assert torch.isfinite(s).all() and (p[..., N:] == 0).all()
    torch.testing.assert_close(s[..., 0], sw[..., 0], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(s[..., 1], sw[..., 1], rtol=1e-4, atol=0)
    diff = (p.float() - pw.float()).abs()
    assert float(diff.max()) <= float(pw.float().abs().max()) * 2 ** -7
    assert float(p[..., :N].float().sum(-1).sub(1).abs().max()) < 0.02
    first = p.clone()
    A.build_cuda(qk, p, s)
    assert torch.equal(p, first)

    gen = torch.Generator().manual_seed(1)
    v = torch.randn((B, N, A.DIM), generator=gen).to(torch.bfloat16).to(cuda_device)
    for dtype in (torch.bfloat16, torch.float32):
        mf = torch.randn((B, N, A.DIM), generator=gen).to(dtype).to(cuda_device)
        gamma = torch.tensor([0.75], dtype=dtype, device=cuda_device)
        out = A.aggregate_cuda(p, v, mf, gamma)
        ref = A.aggregate_plain(p, v, mf, gamma)
        torch.cuda.synchronize()
        tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * float(ref.float().abs().max())
        assert float((out.float() - ref.float()).abs().max()) <= tol, dtype
        assert torch.equal(out, A.aggregate_cuda(p, v, mf, gamma))
    assert A.launches["attention_aggregate"] == 4


def test_attention_wrappers_reject_bad_operands(cuda_device):
    B, N = 2, 96
    qk = _qk(B, N, cuda_device)
    p, s = A.attention_buffers(B, N, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError):
        A.build_cuda(qk.float(), p, s)
    with pytest.raises(ValueError):
        A.build_cuda(qk, p[..., :N].contiguous(), s)            # unpadded P
    v = torch.zeros((B, N, A.DIM), dtype=torch.bfloat16, device=cuda_device)
    mf = torch.zeros((B, N, A.DIM), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        A.aggregate_cuda(p, v, mf, torch.zeros(1, device=cuda_device))   # f32 gamma
    with pytest.raises(ValueError):
        A.aggregate_cuda(p, v.float(), mf, torch.zeros(1, dtype=torch.bfloat16,
                                                        device=cuda_device))


def test_captured_gma_solve_is_bit_equal_to_the_eager_one(cuda_device):
    """`RAFTFlow.compute_batch` with a GMA on the card (bf16, 20 iterations,
    3 pairs x 2 directions at 96x128): the first solve eager, then the
    capture, then replays; every flow equals the eager `raft_flow` of the
    same batch bit for bit; a solve launches one build and 20
    aggregations (none counted by the capture); the attention's buffers
    are made at the key's first, eager solve and at its capture, never in
    a replay."""
    from deflicker_torch.flow import RAFTFlow
    from deflicker_torch.utils import trace

    model = gma_init(torch.Generator().manual_seed(0), gamma=1.0)
    eng = RAFTFlow(model=model, device=cuda_device)
    rng = np.random.default_rng(2)
    made = trace.counters().get("flow.attention_made", 0)
    for n in range(4):
        a = rng.integers(0, 256, (6, 96, 128, 3)).astype(np.float32)
        b = np.roll(a, 3, axis=2)
        A.reset_launches()
        got = eng.compute_batch(a, b)
        torch.cuda.synchronize()
        assert A.launches == {"attention_build": 1, "attention_aggregate": 20}
        assert eng.graphs.captured == 1
        assert list(eng.graphs.entries)[0][3] == "GMA"
        _, want = traft.raft_flow(eng.model, torch.from_numpy(a).to(cuda_device),
                                  torch.from_numpy(b).to(cuda_device),
                                  dtype=torch.bfloat16)
        np.testing.assert_array_equal(got, want.cpu().numpy())
    # the eager comparisons make P each; the engine's first solve and its
    # capture one each, its replays none
    assert trace.counters()["flow.attention_made"] - made == 4 + 2
    A.reset_launches()
