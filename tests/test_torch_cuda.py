"""The CUDA kernels on the card against their plain twins.  Imports no JAX,
so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Every test skips without a CUDA device (a CUDA kernel has no CPU mode)."""

import ctypes

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
    # the dual fit's other two networks: the fewest layers, and output width 1
    "mapping2-256": (dict(input_dim=3, output_dim=2, hidden_dim=256,
                          use_positional=False, num_layers=4, skip_layers=()), 2049),
    "alpha-256": (dict(input_dim=3, output_dim=1, hidden_dim=256,
                       use_positional=True, positional_dim=5, num_layers=8,
                       skip_layers=()), 1111),
    "two-layers": (dict(input_dim=3, output_dim=2, hidden_dim=48,
                        use_positional=False, num_layers=2, skip_layers=()), 65),
}


# the counters of calls with a video axis, all zero in a 2-D run
NO_VIDEO_AXIS = {"fwd_v": 0, "bwd_v": 0, "fwd_stash_v": 0, "bwd_stash_v": 0}


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


def _operands(name, device):
    spec, params, x, g = _case(name, device)
    xe = timlp.positional_encoding(x, spec.positional_dim) if spec.use_positional else x
    ws = [p["w"].detach() for p in params]
    bs = [p["b"].detach() for p in params]
    wb = [w.to(torch.bfloat16).contiguous() for w in ws]
    return xe.contiguous(), ws, wb, bs, g, spec.skip_layers


@pytest.mark.parametrize("name", list(CASES))
def test_stash_kernels_match_plain_and_remat(name, cuda_device):
    """The stash pair on the card.  Forward: output bit-equal to the remat
    forward's (the same device code), stash within one bf16 step of the
    plain twin's on all but a few entries (relative Frobenius 1e-2, as the
    output).  Backward: every gradient bit-equal to the remat backward's
    (the stash holds the very cast the recompute makes), and within 2e-2 of
    the plain stash twin fed the kernel's own stash."""
    xe, ws, wb, bs, g, sk = _operands(name, cuda_device)
    B = xe.shape[0]
    K.reset_launches()
    y, stash = K.imlp_chain_fwd_stash_cuda(xe, wb, bs, sk)
    torch.cuda.synchronize()
    assert K.launches["fwd_stash"] == 1 and K.launches["fwd"] == 0
    # the wrapper and the kernel lay the stash out alike
    assert stash.numel() == K._library().imlp_chain_stash_elems(
        ctypes.byref(K._desc(xe, wb, bs, sk)), B)
    assert torch.equal(y, K.imlp_chain_fwd_cuda(xe, wb, bs, sk))
    y_p, stash_p = K.imlp_chain_fwd_stash_plain(xe, ws, bs, sk)
    assert _rel(y, y_p) < 1e-2
    views = K.stash_views(stash, wb, B)
    assert len(views) == len(stash_p) == len(ws) - 1
    for v, sp in zip(views, stash_p):
        assert v.shape == sp.shape and _rel(v.float(), sp) < 1e-2
    # padding columns of the flat stash are zero
    off = 0
    for w in wb[:-1]:
        wp = (w.shape[1] + 15) // 16 * 16
        assert not stash[off:off + B * wp].view(B, wp)[:, w.shape[1]:].any()
        off += B * wp
    for need_dx in (True, False):
        dx, dW, db = K.imlp_chain_bwd_stash_cuda(xe, wb, bs, sk, stash, g, need_dx)
        dx_r, dW_r, db_r = K.imlp_chain_bwd_cuda(xe, wb, bs, sk, g, need_dx)
        torch.cuda.synchronize()
        assert (dx is None) == (not need_dx)
        if need_dx:
            assert torch.equal(dx, dx_r)
        for a, b in zip(dW + db, dW_r + db_r):
            assert torch.equal(a, b)
        dx_p, dW_p, db_p = K.imlp_chain_bwd_stash_plain(
            xe, ws, bs, sk, [v.float() for v in views], g, need_dx)
        if need_dx:
            assert _rel(dx, dx_p) < 2e-2
        for a, b in zip(dW + db, dW_p + db_p):
            assert _rel(a, b) < 2e-2
    assert K.launches["bwd_stash"] == 2 and K.launches["bwd"] == 2


def test_stash_autograd_on_cuda(cuda_device):
    """imlp_apply_fused(stash_bwd=True) through autograd launches the stash
    pair once each and no remat kernel, and gives the remat path's output
    and gradients bit for bit."""
    spec, params, x, g = _case("atlas-256", cuda_device)
    grads = []
    for stash in (False, True):
        for p in params:
            p["w"].grad = p["b"].grad = None
        K.reset_launches()
        xg = x.clone().requires_grad_()
        y = timlp.imlp_apply_fused(params, xg, spec, stash_bwd=stash)
        (y * g).sum().backward()
        want = ({"fwd": 0, "bwd": 0, "fwd_stash": 1, "bwd_stash": 1} if stash
                else {"fwd": 1, "bwd": 1, "fwd_stash": 0, "bwd_stash": 0})
        assert K.launches == {**want, **NO_VIDEO_AXIS}
        grads.append([y.detach(), xg.grad] + [p[k].grad.clone() for p in params
                                              for k in ("w", "b")])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_stash_wrapper_rejects_bad_stash(cuda_device):
    xe, ws, wb, bs, g, sk = _operands("mapping-64", cuda_device)
    _, stash = K.imlp_chain_fwd_stash_cuda(xe, wb, bs, sk)
    with pytest.raises(ValueError, match="stash"):
        K.imlp_chain_bwd_stash_cuda(xe, wb, bs, sk, stash[:-16], g)
    with pytest.raises(ValueError, match="stash"):
        K.imlp_chain_bwd_stash_cuda(xe, wb, bs, sk, stash.float(), g)
    with pytest.raises(ValueError, match="stash"):
        K.imlp_chain_bwd_stash_cuda(xe, wb, bs, sk, None, g)


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
    assert K.launches == {"fwd": 1, "bwd": 1, "fwd_stash": 0, "bwd_stash": 0,
                          **NO_VIDEO_AXIS}
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
    assert C.launches == {"lookup": 1, "lookup_shared": 0, "lookup_resident": 0}
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
        assert C.launches == {"lookup": 3, "lookup_shared": 0,
                              "lookup_resident": 0}
        assert float((up_k - up_o).abs().max()) < 0.05


# ---------------------------------------------------------------------------
# the shared and resident correlation bodies
# ---------------------------------------------------------------------------

def _corr_operands(B, H, W, D, spread, device, seed=0):
    rng = np.random.default_rng(seed)
    f1 = torch.from_numpy(rng.normal(size=(B, H, W, D)).astype(np.float32))
    f2 = torch.from_numpy(rng.normal(size=(B, H, W, D)).astype(np.float32))
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    coords = np.stack([xs, ys], -1)[None].repeat(B, 0) + rng.uniform(
        -spread, spread, (B, H, W, 2)).astype(np.float32)
    pyr = [lvl.to(torch.bfloat16).contiguous().to(device)
           for lvl in traft.build_fmap_pyramid(f2)]
    return f1.to(device), pyr, torch.from_numpy(coords).to(device)


@pytest.mark.parametrize("spread", [0.5, 3.0, 40.0])
@pytest.mark.parametrize("shape", [(2, 54, 96, 256), (2, 24, 40, 128),
                                   (2, 13, 27, 64), (3, 16, 24, 32),
                                   (1, 7, 9, 32)])
@pytest.mark.parametrize("body", ["shared", "resident"])
def test_corr_bodies_match_plain_and_band(body, shape, spread, cuda_device,
                                          monkeypatch):
    """The shared and resident bodies compute the band body's function from
    other memory: the same bf16 values times the same f32 registers in the
    same order, so bit-equal to the band kernel, and within the band
    kernel's bounds of the plain twin (relative Frobenius 1e-4, max abs
    1e-3 of the largest value)."""
    monkeypatch.delenv("DEFLICKER_CORR_RESIDENT_MAX_MB", raising=False)
    f1, pyr, coords = _corr_operands(*shape, spread, cuda_device)
    band = C.corr_lookup_cuda(f1, pyr, coords)
    C.reset_launches()
    staged = torch.zeros(len(pyr), dtype=torch.int32, device=cuda_device)
    got = C.corr_lookup_cuda(f1, pyr, coords, body=body,
                             staged=staged if body == "shared" else None)
    torch.cuda.synchronize()
    key = {"shared": "lookup_shared", "resident": "lookup_resident"}[body]
    assert C.launches == {"lookup": 0, "lookup_shared": 0,
                          "lookup_resident": 0, key: 1}
    assert torch.equal(got, band)
    want = C.corr_lookup_plain(f1, pyr, coords)
    assert _rel(got, want) < 1e-4
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    if body == "shared":
        blocks = -(-shape[0] * shape[1] * shape[2] // 8)
        assert int(staged.max()) <= blocks
        if spread == 0.5 and shape[2] % 8 == 0:
            # 8 pixels of one row, flow within half a pixel: every window
            # cluster fits the staging envelope at every level
            assert staged.tolist() == [blocks] * len(pyr)


def test_corr_resident_levels_and_gate(cuda_device, monkeypatch):
    """The resident body keeps the coarse levels that fit a block's shared
    memory; with DEFLICKER_CORR_RESIDENT_MAX_MB below a level's bytes that
    level takes the band loads inside the same launch, and the output is
    unchanged."""
    f1, pyr, coords = _corr_operands(2, 54, 96, 256, 3.0, cuda_device)
    shapes = [tuple(p.shape[1:3]) for p in pyr]
    cap = C.resident_capacity()
    assert 200_000 < cap <= 232_448
    monkeypatch.delenv("DEFLICKER_CORR_RESIDENT_MAX_MB", raising=False)
    assert C.resident_levels(shapes, 256, cap) == (2, 3)
    monkeypatch.setenv("DEFLICKER_CORR_RESIDENT_MAX_MB", "0.1")  # < 160 KB
    assert C.resident_levels(shapes, 256, cap, C.resident_gate_bytes()) == (3,)
    band = C.corr_lookup_cuda(f1, pyr, coords)
    got = C.corr_lookup_cuda(f1, pyr, coords, body="resident")
    torch.cuda.synchronize()
    assert torch.equal(got, band)


def test_corr_resident_raises_when_staging_cannot_be_set_up(cuda_device,
                                                            monkeypatch):
    """A resident set larger than a block's shared memory is refused by the
    launch and raised by the wrapper: no quiet fall-back to another body."""
    f1, pyr, coords = _corr_operands(1, 54, 96, 256, 3.0, cuda_device)
    monkeypatch.setattr(C, "resident_levels",
                        lambda shapes, D, cap, gate=None: tuple(range(len(shapes))))
    C.reset_launches()
    with pytest.raises(RuntimeError, match="resident"):
        C.corr_lookup_cuda(f1, pyr, coords, body="resident")
    assert C.launches["lookup_resident"] == 0


def test_raft_flow_runs_the_selected_body(cuda_device, monkeypatch):
    """raft_flow reads the switches once per solve and launches the chosen
    body every GRU iteration; the flow equals the band body's bit for bit."""
    model = traft.raft_init(torch.Generator().manual_seed(0), cuda_device)
    rng = np.random.default_rng(1)
    im1, im2 = (torch.from_numpy(rng.uniform(0, 255, (2, 64, 96, 3))
                                 .astype(np.float32)).to(cuda_device)
                for _ in range(2))
    monkeypatch.delenv("DEFLICKER_CORR_SHARED", raising=False)
    monkeypatch.delenv("DEFLICKER_CORR_RESIDENT", raising=False)
    _, up_band = traft.raft_flow(model, im1, im2, iters=3, corr_mode="kernel")
    for env, key in (("DEFLICKER_CORR_SHARED", "lookup_shared"),
                     ("DEFLICKER_CORR_RESIDENT", "lookup_resident")):
        monkeypatch.setenv(env, "1")
        C.reset_launches()
        _, up = traft.raft_flow(model, im1, im2, iters=3, corr_mode="kernel")
        torch.cuda.synchronize()
        assert C.launches[key] == 3 and C.launches["lookup"] == 0
        assert torch.equal(up, up_band)
        monkeypatch.delenv(env)


# ---------------------------------------------------------------------------
# the chain kernels with a video axis
# ---------------------------------------------------------------------------

def _video_operands(name, V, device):
    """V networks of one case, stacked on a leading axis."""
    kw, B = CASES[name]
    spec = timlp.IMLPSpec(**kw)
    gen = torch.Generator().manual_seed(V)
    params = timlp.imlp_init(spec, gen, device, n_videos=V)
    x = (torch.rand((V, B, spec.input_dim), generator=gen) * 2 - 1).to(device)
    g = torch.randn((V, B, spec.output_dim), generator=gen).to(device)
    xe = timlp.positional_encoding(x, spec.positional_dim) if spec.use_positional else x
    ws = [p["w"].detach() for p in params]
    bs = [p["b"].detach().contiguous() for p in params]
    wb = [w.to(torch.bfloat16).contiguous() for w in ws]
    return xe.contiguous(), ws, wb, bs, g.contiguous(), spec.skip_layers


@pytest.mark.parametrize("V", [1, 3])
@pytest.mark.parametrize("name", ["mapping-64", "atlas-256", "odd-widths",
                                  "alpha-256", "two-layers"])
def test_video_axis_chain_matches_unbatched_and_plain(name, V, cuda_device):
    """One launch over V videos gives, for each video, the one-video
    kernels' results bit for bit (the same device code at another offset),
    both pairs; and the plain twins' within the chain bounds (1e-2 forward,
    2e-2 backward).  Each wrapper call counts once under its "_v" key."""
    xe, ws, wb, bs, g, sk = _video_operands(name, V, cuda_device)
    K.reset_launches()
    y = K.imlp_chain_fwd_cuda(xe, wb, bs, sk)
    ys, stash = K.imlp_chain_fwd_stash_cuda(xe, wb, bs, sk)
    grads = {need: K.imlp_chain_bwd_cuda(xe, wb, bs, sk, g, need)
             for need in (True, False)}
    sgrads = K.imlp_chain_bwd_stash_cuda(xe, wb, bs, sk, stash, g, True)
    torch.cuda.synchronize()
    assert K.launches == {"fwd": 0, "bwd": 0, "fwd_stash": 0, "bwd_stash": 0,
                          "fwd_v": 1, "bwd_v": 2, "fwd_stash_v": 1,
                          "bwd_stash_v": 1}
    assert y.shape == (V, xe.shape[1], ws[-1].shape[-1]) and torch.equal(y, ys)
    for v in range(V):
        wv, bv = [w[v] for w in wb], [b[v] for b in bs]
        assert torch.equal(y[v], K.imlp_chain_fwd_cuda(xe[v], wv, bv, sk))
        y1, st1 = K.imlp_chain_fwd_stash_cuda(xe[v], wv, bv, sk)
        assert torch.equal(stash[v], st1)
        for need, (dx, dW, db) in grads.items():
            dx1, dW1, db1 = K.imlp_chain_bwd_cuda(xe[v], wv, bv, sk, g[v], need)
            assert (dx is None) == (not need)
            if need:
                assert torch.equal(dx[v], dx1)
            for a, b in zip(dW + db, dW1 + db1):
                assert torch.equal(a[v], b)
        for a, b in zip([sgrads[0]] + sgrads[1] + sgrads[2],
                        [grads[True][0]] + grads[True][1] + grads[True][2]):
            assert torch.equal(a, b)
    assert _rel(y, K.imlp_chain_fwd_plain(xe, ws, bs, sk)) < 1e-2
    dx_p, dW_p, db_p = K.imlp_chain_bwd_plain(xe, ws, bs, sk, g, True)
    dx, dW, db = grads[True]
    for a, b in zip([dx] + dW + db, [dx_p] + dW_p + db_p):
        assert _rel(a, b) < 2e-2


def test_video_axis_autograd_on_cuda(cuda_device):
    """imlp_apply_fused on stacked params: one launch each way for all V
    networks, gradients per video equal to one-video autograd's."""
    kw, B = CASES["atlas-64"]
    spec = timlp.IMLPSpec(**kw)
    V = 3
    params = timlp.imlp_init(spec, torch.Generator().manual_seed(5), cuda_device,
                             n_videos=V)
    x = torch.rand((V, B, spec.input_dim), device=cuda_device)
    K.reset_launches()
    (timlp.imlp_apply_fused(params, x, spec) ** 2).sum().backward()
    assert K.launches["fwd_v"] == 1 and K.launches["bwd_v"] == 1
    for v in range(V):
        one = [{k: p[k].detach()[v].clone().requires_grad_() for k in ("w", "b")}
               for p in params]
        (timlp.imlp_apply_fused(one, x[v], spec) ** 2).sum().backward()
        for p, q in zip(params, one):
            assert torch.equal(p["w"].grad[v], q["w"].grad)
            assert torch.equal(p["b"].grad[v], q["b"].grad)


# ---------------------------------------------------------------------------
# the backward at the edges of its tiles and row slices
# ---------------------------------------------------------------------------

def _edge_batches(spec, device):
    """1, 63, 64, 127, 128, 129 (wgmma takes 64 rows, a reverse-pass tile
    128), then S - 1, S, S + 1 for the first S >= 3000 that is a multiple
    of the dW GEMM's row slice at S rows (the last slice full, one row
    short, one row over)."""
    params = timlp.imlp_init(spec, torch.Generator().manual_seed(0), device)
    wb = [p["w"].detach().to(torch.bfloat16).contiguous() for p in params]
    bs = [p["b"].detach() for p in params]
    lib = K._library()
    E = wb[0].shape[0]
    S = 3000
    while True:
        xe = torch.zeros((S, E), device=device)
        rows = lib.imlp_chain_dw_slice_rows(
            ctypes.byref(K._desc(xe, wb, bs, spec.skip_layers)), S)
        if S % rows == 0 and S // rows > 1:
            break
        S += 1
    return [1, 63, 64, 127, 128, 129, S - 1, S, S + 1]


@pytest.mark.parametrize("name", list(CASES))
def test_backward_at_tile_and_slice_edges(name, cuda_device):
    """The reverse pass and the dW GEMM at batch sizes around their tiles and
    slices, with and without dx, one video and three: stash and remat
    gradients bit-equal, two calls bit-equal, a V = 3 call bit-equal to the
    one-video calls, and within 2e-2 (relative Frobenius) of the plain stash
    twin fed the kernel's own stash."""
    kw, _ = CASES[name]
    spec = timlp.IMLPSpec(**kw)
    sk = spec.skip_layers
    for B in _edge_batches(spec, cuda_device):
        for V in (1, 3):
            gen = torch.Generator().manual_seed(B)
            params = timlp.imlp_init(spec, gen, cuda_device, n_videos=V if V > 1 else None)
            lead = (V,) if V > 1 else ()
            x = (torch.rand(lead + (B, spec.input_dim), generator=gen) * 2 - 1).to(cuda_device)
            g = torch.randn(lead + (B, spec.output_dim), generator=gen).to(cuda_device)
            xe = (timlp.positional_encoding(x, spec.positional_dim)
                  if spec.use_positional else x).contiguous()
            ws = [p["w"].detach() for p in params]
            bs = [p["b"].detach().contiguous() for p in params]
            wb = [w.to(torch.bfloat16).contiguous() for w in ws]
            _, stash = K.imlp_chain_fwd_stash_cuda(xe, wb, bs, sk)
            for need_dx in (True, False):
                flat = lambda r: ([r[0]] if need_dx else []) + r[1] + r[2]
                rem = flat(K.imlp_chain_bwd_cuda(xe, wb, bs, sk, g, need_dx))
                sta = flat(K.imlp_chain_bwd_stash_cuda(xe, wb, bs, sk, stash, g, need_dx))
                again = flat(K.imlp_chain_bwd_cuda(xe, wb, bs, sk, g, need_dx))
                torch.cuda.synchronize()
                where = f"B={B} V={V} dx={need_dx}"
                assert all(torch.equal(a, b) for a, b in zip(rem, sta)), where
                assert all(torch.equal(a, b) for a, b in zip(rem, again)), where
                if V > 1:
                    for v in range(V):
                        one = flat(K.imlp_chain_bwd_cuda(
                            xe[v], [w[v] for w in wb], [b[v] for b in bs], sk, g[v],
                            need_dx))
                        assert all(torch.equal(a[v], b) for a, b in zip(rem, one)), where
                views = ([K.stash_views(stash[v], [w[v] for w in wb], B)
                          for v in range(V)] if V > 1
                         else K.stash_views(stash, wb, B))
                views = ([torch.stack([vv[i] for vv in views]).float()
                          for i in range(len(ws) - 1)] if V > 1
                         else [vv.float() for vv in views])
                want = flat(K.imlp_chain_bwd_stash_plain(xe, ws, bs, sk, views, g,
                                                         need_dx))
                for a, b in zip(rem, want):
                    assert torch.isfinite(a).all() and _rel(a, b) < 2e-2, where
