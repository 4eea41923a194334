"""The CUDA kernels on the card against their plain twins.  Imports no JAX,
so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Every test skips without a CUDA device (a CUDA kernel has no CPU mode)."""

import numpy as np
import pytest
import torch

from deflicker_torch.models import imlp as timlp
from deflicker_torch.models import raft as traft
from deflicker_torch.ops.cuda import corr_kernel as C
from deflicker_torch.ops.cuda import imlp_kernel as K

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

# narrow and full-width copies of the fit's two networks, ragged batches
CASES = {
    "mapping-64": (dict(input_dim=3, output_dim=2, hidden_dim=64,
                        use_positional=False, num_layers=6, skip_layers=()), 1000),
    "atlas-64": (dict(input_dim=2, output_dim=3, hidden_dim=64,
                      use_positional=True, positional_dim=10, num_layers=8,
                      skip_layers=(4, 7)), 777),
    "atlas-256": (dict(input_dim=2, output_dim=3, hidden_dim=256,
                       use_positional=True, positional_dim=10, num_layers=8,
                       skip_layers=(4, 7)), 3001),
    "odd-widths": (dict(input_dim=5, output_dim=1, hidden_dim=40,
                        use_positional=False, num_layers=5, skip_layers=(2,)), 130),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _case(name, device):
    kw, B = CASES[name]
    spec = timlp.IMLPSpec(**kw)
    gen = torch.Generator().manual_seed(0)
    params = timlp.imlp_init(spec, gen, device)
    x = (torch.rand((B, spec.input_dim), generator=gen) * 2 - 1).to(device)
    g = torch.randn((B, spec.output_dim), generator=gen).to(device)
    return spec, params, x, g


@pytest.mark.parametrize("name", list(CASES))
def test_kernels_match_plain(name, cuda_device):
    """Forward and backward kernels vs the plain twins on the same inputs
    (relative Frobenius 1e-2 forward, 2e-2 backward: both round operands to
    bf16 and sum in f32 in different orders, which can round a bf16
    gradient the other way)."""
    spec, params, x, g = _case(name, cuda_device)
    xe = timlp.positional_encoding(x, spec.positional_dim) if spec.use_positional else x
    xe = xe.contiguous()
    ws = [p["w"].detach() for p in params]
    bs = [p["b"].detach() for p in params]
    wb = [w.to(torch.bfloat16).contiguous() for w in ws]
    sk = spec.skip_layers
    y = K.imlp_chain_fwd_cuda(xe, wb, bs, sk)
    torch.cuda.synchronize()
    assert _rel(y, K.imlp_chain_fwd_plain(xe, ws, bs, sk)) < 1e-2
    for need_dx in (True, False):
        dx, dW, db = K.imlp_chain_bwd_cuda(xe, wb, bs, sk, g, need_dx)
        torch.cuda.synchronize()
        dx_p, dW_p, db_p = K.imlp_chain_bwd_plain(xe, ws, bs, sk, g, need_dx)
        assert (dx is None) == (not need_dx)
        if need_dx:
            assert _rel(dx, dx_p) < 2e-2
        for a, b in zip(dW + db, dW_p + db_p):
            assert _rel(a, b) < 2e-2


def test_backward_is_deterministic(cuda_device):
    """Fixed-order sums (no atomics): two backward launches agree bitwise."""
    spec, params, x, g = _case("atlas-256", cuda_device)
    xe = timlp.positional_encoding(x, spec.positional_dim).contiguous()
    wb = [p["w"].detach().to(torch.bfloat16).contiguous() for p in params]
    bs = [p["b"].detach() for p in params]
    a = K.imlp_chain_bwd_cuda(xe, wb, bs, spec.skip_layers, g, True)
    b = K.imlp_chain_bwd_cuda(xe, wb, bs, spec.skip_layers, g, True)
    for u, v in zip([a[0]] + a[1] + a[2], [b[0]] + b[1] + b[2]):
        assert torch.equal(u, v)


def test_autograd_on_cuda_matches_cpu_twin(cuda_device):
    """imlp_apply_fused through autograd: the kernels on the card and the
    plain twins on the CPU give the same loss and gradients (bounds as
    above), and each call launches each kernel once."""
    spec, params, x, g = _case("atlas-64", cuda_device)
    K.reset_launches()
    xg = x.clone().requires_grad_()
    (timlp.imlp_apply_fused(params, xg, spec) * g).sum().backward()
    assert K.launches == {"fwd": 1, "bwd": 1}
    cpu = [{k: v.detach().cpu().requires_grad_() for k, v in p.items()}
           for p in params]
    xc = x.cpu().requires_grad_()
    (timlp.imlp_apply_fused(cpu, xc, spec) * g.cpu()).sum().backward()
    assert _rel(xg.grad.cpu(), xc.grad) < 2e-2
    for p, q in zip(params, cpu):
        assert _rel(p["w"].grad.cpu(), q["w"].grad) < 2e-2


def test_wrapper_rejects_bad_operands(cuda_device):
    spec, params, x, g = _case("mapping-64", cuda_device)
    ws = [p["w"].detach() for p in params]
    bs = [p["b"].detach() for p in params]
    with pytest.raises(ValueError, match="bf16"):
        K.imlp_chain_fwd_cuda(x, ws, bs, ())          # f32 weights
    wb = [w.to(torch.bfloat16).contiguous() for w in ws]
    with pytest.raises(ValueError, match="contiguous"):
        K.imlp_chain_fwd_cuda(x.t().contiguous().t(), wb, bs, ())


# ---------------------------------------------------------------------------
# correlation-window lookup
# ---------------------------------------------------------------------------

# (B, H, W, D, spread): the flow engine's width at a smaller batch, windows
# far outside the level, the ragged case with an empty level, other widths
CORR_CASES = {
    "engine-54x96": (2, 54, 96, 256, 3.0),
    "far-out": (2, 54, 96, 256, 40.0),
    "ragged-7x9": (1, 7, 9, 32, 2.0),
    "d64-12x20": (2, 12, 20, 64, 5.0),
    "d128-13x27": (1, 13, 27, 128, 5.0),
}


def _corr_case(name, device):
    B, H, W, D, spread = CORR_CASES[name]
    rng = np.random.default_rng(0)
    f1 = torch.from_numpy(rng.normal(size=(B, H, W, D)).astype(np.float32))
    f2 = torch.from_numpy(rng.normal(size=(B, H, W, D)).astype(np.float32))
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    coords = np.stack([xs, ys], -1)[None].repeat(B, 0) + rng.uniform(
        -spread, spread, (B, H, W, 2)).astype(np.float32)
    pyr = [lvl.to(torch.bfloat16).contiguous().to(device)
           for lvl in traft.build_fmap_pyramid(f2)]
    return f1.to(device), pyr, torch.from_numpy(coords).to(device)


@pytest.mark.parametrize("name", list(CORR_CASES))
def test_corr_kernel_matches_plain(name, cuda_device):
    """Kernel vs plain twin on the same bf16-stored pyramid: both multiply
    the same rounded f2 by f32 f1 and differ only in the order of f32 sums,
    so relative Frobenius 1e-4 and max abs 1e-3 of the largest value."""
    f1, pyr, coords = _corr_case(name, cuda_device)
    C.reset_launches()
    got = C.corr_lookup_cuda(f1, pyr, coords)
    torch.cuda.synchronize()
    assert C.launches == {"lookup": 1}
    want = C.corr_lookup_plain(f1, pyr, coords)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _rel(got, want) < 1e-4
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    if name == "far-out":
        assert float((want == 0).float().mean()) > 0.2      # windows left the level
    if name == "ragged-7x9":
        assert not got[..., 3 * 81:].any()                  # the empty level


def test_corr_kernel_survives_wild_coordinates(cuda_device):
    """Untrained weights drive the flow anywhere: huge, infinite and NaN
    coordinates are clamped inside the kernel and read zeros or finite
    values, never out of bounds."""
    f1, pyr, coords = _corr_case("d64-12x20", cuda_device)
    coords = coords.clone()
    coords[0, 0, 0] = torch.tensor([1e30, -1e30])
    coords[0, 0, 1] = torch.tensor([float("inf"), float("-inf")])
    coords[0, 0, 2] = torch.tensor([float("nan"), 3.0])
    got = C.corr_lookup_cuda(f1, pyr, coords)
    torch.cuda.synchronize()
    assert not got[0, 0, :2].any()
    assert torch.isfinite(got[0, 0, 3:]).all()


def test_corr_wrapper_rejects_bad_operands(cuda_device):
    f1, pyr, coords = _corr_case("d64-12x20", cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        C.corr_lookup_cuda(f1, [p.float() for p in pyr], coords)
    with pytest.raises(ValueError, match="radius"):
        C.corr_lookup_cuda(f1, pyr, coords, radius=3)
    with pytest.raises(ValueError, match="contiguous"):
        C.corr_lookup_cuda(f1, pyr, coords.flip(-1).flip(-1).transpose(1, 2)
                           .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        C.corr_lookup_cuda(f1.cpu(), pyr, coords)


def test_raft_flow_kernel_mode_matches_online_on_card(cuda_device):
    """raft_flow on the card: `auto` and `kernel` launch the CUDA kernel once
    per GRU iteration and stay within bf16 storage tolerance (0.05) of the
    f32 online gather."""
    model = traft.raft_init(torch.Generator().manual_seed(0), cuda_device)
    rng = np.random.default_rng(1)
    im1, im2 = (torch.from_numpy(rng.uniform(0, 255, (2, 64, 96, 3))
                                 .astype(np.float32)).to(cuda_device)
                for _ in range(2))
    _, up_o = traft.raft_flow(model, im1, im2, iters=3, corr_mode="online")
    for mode in ("kernel", "auto"):
        C.reset_launches()
        _, up_k = traft.raft_flow(model, im1, im2, iters=3, corr_mode=mode)
        torch.cuda.synchronize()
        assert C.launches == {"lookup": 3}
        assert float((up_k - up_o).abs().max()) < 0.05
