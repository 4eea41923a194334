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
    # encoded inputs wider than 64 at the widest layers: E = 80 (two x-tile
    # atoms, skip layers of 4 + 2 slabs a half) and E = 210 (four atoms:
    # a skip layer's 4 + 4 slabs a half outnumber the forward's 6 stages)
    "wide-input-80": (dict(input_dim=2, output_dim=3, hidden_dim=256,
                           use_positional=True, positional_dim=20, num_layers=8,
                           skip_layers=(4, 7)), 1500),
    "wide-input-210": (dict(input_dim=3, output_dim=2, hidden_dim=256,
                            use_positional=True, positional_dim=35, num_layers=6,
                            skip_layers=(3,)), 700),
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

# (B, H, W, D, spread): the flow engine's width at a smaller batch (windows
# inside the levels at +-3 and +-0.5 px), windows far outside the level, the
# ragged case with an empty level, other widths
CORR_CASES = {
    "engine-54x96": (2, 54, 96, 256, 3.0),
    "engine-54x96-0.5": (2, 54, 96, 256, 0.5),
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
    """The band body (each window one mma.sync product, f1 as three bf16
    terms) vs the plain twin on the same bf16-stored pyramid: both multiply
    the same rounded f2 by all of f32 f1's bits and differ only in the order
    of f32 sums, so relative Frobenius 1e-4 and max abs 1e-3 of the largest
    value; two calls are bit-equal."""
    f1, pyr, coords = _corr_case(name, cuda_device)
    C.reset_launches()
    got = C.corr_lookup_cuda(f1, pyr, coords)
    torch.cuda.synchronize()
    assert C.launches == {"lookup": 1, "lookup_shared": 0, "lookup_resident": 0}
    assert torch.equal(C.corr_lookup_cuda(f1, pyr, coords), got)
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


def _staged_want(shape, spread, pyr, coords):
    """What the shared body's counters must read: the tiles `tile_plan`
    stages at each level (all of a non-empty level's tiles at +-0.5 and
    +-3 px); none at D = 32, where the band body runs."""
    if shape[3] == 32:
        return [0] * len(pyr)
    plan = C.tile_plan(coords, [tuple(p.shape[1:3]) for p in pyr])
    want = [int(n) for n in plan.flatten(1).sum(1).tolist()]
    if spread <= 3.0:
        tiles = shape[0] * -(-shape[1] // 8) * -(-shape[2] // 8)
        assert want == [tiles if p.numel() else 0 for p in pyr]
    return want


@pytest.mark.parametrize("spread", [0.5, 3.0, 40.0])
@pytest.mark.parametrize("shape", [(2, 54, 96, 256), (2, 24, 40, 128),
                                   (2, 13, 27, 64), (3, 16, 24, 32),
                                   (1, 7, 9, 32)])
@pytest.mark.parametrize("body", ["shared", "resident"])
def test_corr_bodies_match_plain_and_band(body, shape, spread, cuda_device,
                                          monkeypatch):
    """The shared and resident bodies compute the band body's function on
    the tensor cores (D >= 64; at D = 32 they take the band body and equal
    it bit for bit): within the band kernel's bounds of the plain twin
    (relative Frobenius 1e-4, max abs 1e-3 of the largest value) and of the
    band kernel's output; two calls are bit-equal; shared and resident are
    bit-equal wherever every tile of each resident level stages in the
    shared body (the same wgmma chain; the other levels take the same route
    in both, at +-40 px the band body's products for unstaged tiles): at
    every spread at the engine's shape, at +-0.5 px at all shapes; the
    shared body's counters read the tiles that staged."""
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
    assert torch.equal(C.corr_lookup_cuda(f1, pyr, coords, body=body), got)
    want = C.corr_lookup_plain(f1, pyr, coords)
    assert _rel(got, want) < 1e-4
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    assert _rel(got, band) < 1e-4
    if shape[3] == 32:
        assert torch.equal(got, band)
    shapes = [tuple(p.shape[1:3]) for p in pyr]
    plan = C.tile_plan(coords, shapes)
    kept = C.resident_levels(shapes, shape[3], C.resident_capacity())
    if shape == (2, 54, 96, 256) or spread == 0.5:
        assert all(bool(plan[l].all()) for l in kept)
    if all(bool(plan[l].all()) for l in kept):
        other = "resident" if body == "shared" else "shared"
        assert torch.equal(got, C.corr_lookup_cuda(f1, pyr, coords, body=other))
    if body == "shared":
        assert staged.tolist() == _staged_want(shape, spread, pyr, coords)


@pytest.mark.parametrize("spread", [3.0, 6.0])
@pytest.mark.parametrize("shape", [(1, 13, 27, 64), (3, 20, 36, 128),
                                   (1, 9, 17, 256), (3, 54, 96, 256)])
def test_corr_tensor_core_bodies_at_tile_edges(shape, spread, cuda_device,
                                               monkeypatch):
    """Tiles past the grid's ragged edge (H, W not multiples of 8), B = 1
    and 3, and unions of up to 4 x 4 blocks of 8 x 8 positions (+-6 px: a
    level-0 union of up to 30 positions a side, 16 blocks through the TMA
    ring): both bodies within the plain twin's bounds, the shared body's
    counters equal to the tile plan, and where every tile stages, shared
    and resident bit-equal."""
    monkeypatch.delenv("DEFLICKER_CORR_RESIDENT_MAX_MB", raising=False)
    f1, pyr, coords = _corr_operands(*shape, spread, cuda_device, seed=3)
    want = C.corr_lookup_plain(f1, pyr, coords)
    staged = torch.zeros(len(pyr), dtype=torch.int32, device=cuda_device)
    shared = C.corr_lookup_cuda(f1, pyr, coords, body="shared", staged=staged)
    resident = C.corr_lookup_cuda(f1, pyr, coords, body="resident")
    torch.cuda.synchronize()
    for got in (shared, resident):
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) < 1e-4
        assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    plan = C.tile_plan(coords, [tuple(p.shape[1:3]) for p in pyr])
    assert staged.tolist() == [int(n) for n in plan.flatten(1).sum(1).tolist()]
    if bool(plan[[l for l, p in enumerate(pyr) if p.numel()]].all()):
        assert torch.equal(shared, resident)


def test_corr_resident_levels_and_gate(cuda_device, monkeypatch):
    """The capacity is a block's opt-in shared memory less what the kernel
    takes besides the levels at D = 256 (A's two terms 65,536 B, the rings
    98,304, the tables 25,600, barriers and alignment 1,280): at the
    engine's shape level 3 (36,864 B) is resident and level 2 (159,744)
    is not.  With DEFLICKER_CORR_RESIDENT_MAX_MB below level 3's bytes no
    level is resident, and the resident body is then the shared body,
    bit for bit; with level 3 resident it is too at +-3 px (every tile of
    the other levels stages)."""
    f1, pyr, coords = _corr_operands(2, 54, 96, 256, 3.0, cuda_device)
    shapes = [tuple(p.shape[1:3]) for p in pyr]
    cap = C.resident_capacity()
    assert cap == 232_448 - 190_720            # the H100's opt-in maximum
    monkeypatch.delenv("DEFLICKER_CORR_RESIDENT_MAX_MB", raising=False)
    assert C.resident_levels(shapes, 256, cap) == (3,)
    shared = C.corr_lookup_cuda(f1, pyr, coords, body="shared")
    got = C.corr_lookup_cuda(f1, pyr, coords, body="resident")
    monkeypatch.setenv("DEFLICKER_CORR_RESIDENT_MAX_MB", "0.03")  # < 36,864 B
    assert C.resident_levels(shapes, 256, cap, C.resident_gate_bytes()) == ()
    none = C.corr_lookup_cuda(f1, pyr, coords, body="resident")
    torch.cuda.synchronize()
    assert torch.equal(got, shared)
    assert torch.equal(none, shared)


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
    body every GRU iteration; the flow agrees with the band body's within
    the bound the kernel mode holds against the online mode (0.05 px): the
    tensor-core bodies sum each dot in another order."""
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
        assert float((up - up_band).abs().max()) < 0.05
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


# ---------------------------------------------------------------------------
# the forward at the edges of its tiles
# ---------------------------------------------------------------------------

FWD_EDGE_BATCHES = (1, 63, 64, 65, 127, 128, 129, 257)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_at_tile_edges(name, cuda_device):
    """The forward kernels around a warpgroup's 64 rows and a block's
    128-row tile, one video and three.  Rows are independent, so each edge
    batch must give the first rows of a 300-row call's output and stash bit
    for bit (nothing of a row depends on its neighbours, nothing lands past
    B); the 300-row call within 1e-2 (relative Frobenius, as above) of the
    plain twins, output and every stash layer, its stash padding zero; the
    stash forward's output bit-equal to the forward's; a V = 3 call
    bit-equal to the one-video calls."""
    kw, _ = CASES[name]
    spec = timlp.IMLPSpec(**kw)
    sk = spec.skip_layers
    big = 300
    for V in (1, 3):
        gen = torch.Generator().manual_seed(V)
        params = timlp.imlp_init(spec, gen, cuda_device, n_videos=V if V > 1 else None)
        lead = (V,) if V > 1 else ()
        x = (torch.rand(lead + (big, spec.input_dim), generator=gen) * 2 - 1).to(cuda_device)
        xe = (timlp.positional_encoding(x, spec.positional_dim)
              if spec.use_positional else x).contiguous()
        ws = [p["w"].detach() for p in params]
        bs = [p["b"].detach().contiguous() for p in params]
        wb = [w.to(torch.bfloat16).contiguous() for w in ws]

        def views(stash, B, v=None):
            if v is None:
                return K.stash_views(stash, wb, B)
            return K.stash_views(stash[v], [w[v] for w in wb], B)

        y, stash = K.imlp_chain_fwd_stash_cuda(xe, wb, bs, sk)
        torch.cuda.synchronize()
        assert torch.equal(y, K.imlp_chain_fwd_cuda(xe, wb, bs, sk))
        y_p, stash_p = K.imlp_chain_fwd_stash_plain(xe, ws, bs, sk)
        assert _rel(y, y_p) < 1e-2
        for v in range(V):
            got = views(stash, big, v if V > 1 else None)
            for i, a in enumerate(got):
                want = stash_p[i][v] if V > 1 else stash_p[i]
                assert _rel(a.float(), want) < 1e-2, (V, v, i)
        flat = stash.view(V, -1) if V > 1 else stash.view(1, -1)
        for v in range(V):
            off = 0
            for w in wb[:-1]:
                width = w.shape[-1]
                wp = (width + 15) // 16 * 16
                assert not flat[v, off:off + big * wp].view(big, wp)[:, width:].any()
                off += big * wp
        if V > 1:
            for v in range(V):
                wv, bv = [w[v] for w in wb], [b[v] for b in bs]
                y1, st1 = K.imlp_chain_fwd_stash_cuda(xe[v], wv, bv, sk)
                assert torch.equal(y[v], y1) and torch.equal(stash[v], st1)
        for B in FWD_EDGE_BATCHES:
            xb = xe[..., :B, :].contiguous()
            yb = K.imlp_chain_fwd_cuda(xb, wb, bs, sk)
            ysb, stb = K.imlp_chain_fwd_stash_cuda(xb, wb, bs, sk)
            torch.cuda.synchronize()
            where = f"B={B} V={V}"
            assert torch.equal(yb, y[..., :B, :]) and torch.equal(ysb, yb), where
            for v in range(V):
                vv = v if V > 1 else None
                for a, b in zip(views(stb, B, vv), views(stash, big, vv)):
                    assert torch.equal(a, b[:B]), where


@pytest.mark.parametrize("p", [1, 3])
def test_reflect_pad_backward_is_bit_reproducible_on_card(p, cuda_device):
    """The refiner's reflection pad on the card (p = 1 and 3, its 3x3 and
    7x7 convs): forward equal to F.pad's, backward the same on two calls
    (CUDA's own two-axis reflection-pad backward adds up to four
    gradients a source with atomics), within f32 rounding of F.pad's."""
    import torch.nn.functional as F

    from deflicker_torch.models.refine import _reflect_pad

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, 64, 64, generator=gen).to(cuda_device)
    g = torch.randn(2, 32, 64 + 2 * p, 64 + 2 * p, generator=gen).to(cuda_device)
    x.requires_grad_()
    assert torch.equal(_reflect_pad(x, p), F.pad(x, (p, p, p, p), mode="reflect"))
    a, b = (torch.autograd.grad((_reflect_pad(x, p) * g).sum(), x)[0]
            for _ in range(2))
    assert torch.equal(a, b)
    want = torch.autograd.grad((F.pad(x, (p, p, p, p), mode="reflect")
                                * g).sum(), x)[0]
    torch.testing.assert_close(a, want, rtol=1e-6, atol=1e-5)


def test_refiner_backward_is_bit_reproducible_on_card(cuda_device):
    """The TransformNet's backward on the card as stage-2 training runs it
    (bf16 autocast) gives the same gradients on two calls."""
    from deflicker_torch.models.refine import transformnet_init

    gen = torch.Generator().manual_seed(0)
    net = transformnet_init(gen).to(cuda_device)
    x = torch.rand(2, 12, 128, 128, generator=gen).to(cuda_device)
    grads = []
    for _ in range(2):
        net.zero_grad()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = net(x)
        (y.float() ** 2).sum().backward()
        grads.append([p.grad.clone() for p in net.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_stage2_repeats_bit_for_bit_on_card(dtype, cuda_device,
                                                 tmp_path):
    """Two `train_stage2` runs of one seed on the card, as `_run` sets up
    its steps (cuDNN's deterministic algorithms in f32), give the same
    chunk losses and the same weights to the bit."""
    from deflicker_torch.train.stage2_trainer import TrainConfig, train_stage2
    from deflicker_torch.utils.checkpoint import load_checkpoint

    cfg = TrainConfig(height=64, width=64, filter_steps=10, refine_steps=10,
                      steps_per_call=5, dtype=dtype, seed=3)
    runs = []
    for r in range(2):
        out = tmp_path / f"run{r}"
        paths = train_stage2(cfg, out, device=cuda_device)
        runs.append(((out / "scalars.jsonl").read_text(),
                     [load_checkpoint(p) for p in paths]))
    assert runs[0][0] == runs[1][0]
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for t in tree for x in leaves(t)]
        return [tree]

    flat = [leaves(ckpts) for _, ckpts in runs]
    assert len(flat[0]) == len(flat[1]) > 0
    for a, b in zip(*flat):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the stage-1 fit as CUDA graphs (atlas/graphs.py)
# ---------------------------------------------------------------------------

def _fit_case(device, dual=False, T=6, H=40, W=56, V=None, seed=0):
    """A random VideoData (its pack on `device`), narrow specs, a config
    whose global rigidity stops at step 20 (the dual bootstrap at 30), and
    fresh params."""
    import dataclasses

    from deflicker_torch.atlas import engine as E
    from deflicker_torch.atlas.data import VideoData
    from deflicker_torch.atlas.multifit import init_models_multi
    from deflicker_torch.config import AtlasConfig

    rng = np.random.default_rng(seed)

    def one():
        f32 = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
        return VideoData(f32(T, H, W, 3), f32(T, H, W, 3) - 0.5,
                         f32(T, H, W, 3) - 0.5, (f32(T, H, W) > 0.5) * 1.0,
                         3 * f32(T, H, W, 2) - 1.5, 3 * f32(T, H, W, 2) - 1.5,
                         (f32(T, H, W) > 0.3) * 1.0, (f32(T, H, W) > 0.3) * 1.0)

    cfg = dataclasses.replace(
        AtlasConfig(), samples_batch=2000, number_of_channels_atlas=64,
        number_of_channels_mapping1=64, number_of_channels_mapping2=64,
        number_of_channels_alpha=64, steps_per_call=10, evaluate_every=10 ** 6,
        stop_global_rigidity=20, stop_bootstrapping_iteration=30,
        global_rigidity_derivative_amount_fg=5,
        global_rigidity_derivative_amount_bg=5)
    specs = E.build_specs(cfg, dual=dual)
    if V is None:
        data = one().with_packed(device)
        params = E.init_models(specs, torch.Generator().manual_seed(seed), device)
    else:
        from deflicker_torch.atlas.multifit import stack_video_data

        data = stack_video_data([one() for _ in range(V)], device)
        params = init_models_multi(specs, torch.Generator().manual_seed(seed),
                                   V, device)
    return cfg, specs, data, params


def _clone(params):
    return {k: [{kk: t.detach().clone().requires_grad_() for kk, t in l.items()}
                for l in v] for k, v in params.items()}


def _run_fit(params, specs, data, cfg, device, graphs=None, V=None, **kw):
    """(params, host Adam state, logs, generator state) of a fit from seed
    3 through `graphs` (None: the fit's own); `kw` to fit_atlas /
    fit_atlas_multi."""
    from deflicker_torch.atlas import engine as E
    from deflicker_torch.atlas.multifit import fit_atlas_multi

    gen = torch.Generator(device=device).manual_seed(3)
    p = _clone(params)
    if V is None:
        res = E.fit_atlas(p, specs, data, cfg, gen, graphs=graphs, **kw)
        return p, res.opt_state, res.logs, gen.get_state()
    res = fit_atlas_multi(p, specs, data, cfg, gen, graphs=graphs, **kw)
    return (p, [r.opt_state for r in res], [r.logs for r in res],
            gen.get_state())


def _assert_same_fit(a, b):
    pa, oa, la, ga = a
    pb, ob, lb, gb = b
    for x, y in zip(*([t for n in sorted(p) for l in p[n]
                       for t in (l["w"], l["b"])] for p in (pa, pb))):
        assert torch.equal(x, y)
    for sa, sb in zip(oa if isinstance(oa, list) else [oa],
                      ob if isinstance(ob, list) else [ob]):
        assert sa["step"] == sb["step"]
        for k in ("exp_avg", "exp_avg_sq"):
            for x, y in zip(sa[k], sb[k]):
                np.testing.assert_array_equal(x, y)
    assert la == lb
    assert torch.equal(ga, gb)


def test_captured_randint_draws_equal_eager_draws(cuda_device):
    """The fit's draws (j, i, f of three shapes) from a generator registered
    with a graph: each replay draws what the eager calls draw from the same
    state, and the generator's state after the replays is the eager one's."""
    shapes = [((2000,), 56), ((2000,), 40), ((3, 2000), 6)]
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    start = gen.get_state()
    eager = [[torch.randint(0, n, s, generator=gen, device=cuda_device)
              for s, n in shapes] for _ in range(5)]
    after = gen.get_state()
    gen.set_state(start)
    out = [torch.zeros(s, dtype=torch.int64, device=cuda_device)
           for s, _ in shapes]
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        for o, (s, n) in zip(out, shapes):
            o.copy_(torch.randint(0, n, s, generator=gen, device=cuda_device))
    assert torch.equal(gen.get_state(), start)      # capture draws nothing
    for step in eager:
        graph.replay()
        for o, e in zip(out, step):
            assert torch.equal(o, e)
    assert torch.equal(gen.get_state(), after)


@pytest.mark.parametrize("dual", [False, True])
def test_captured_fit_equals_the_eager_fit(dual, cuda_device):
    """50 fit steps across the global-rigidity stop (and, dual, the
    bootstrap's): captured and eager fits bit-equal in params, Adam state,
    chunk logs and the generator's state; one graph a loss phase; the chain
    counters read networks x steps after the captured fit."""
    from deflicker_torch.atlas.graphs import FitGraphs

    cfg, specs, data, params = _fit_case(cuda_device, dual=dual)
    import dataclasses

    cfg = dataclasses.replace(cfg, iters_num=50)
    eager = _run_fit(params, specs, data, cfg, cuda_device,
                     FitGraphs(eager=True))
    graphs = FitGraphs()
    K.reset_launches()
    captured = _run_fit(params, specs, data, cfg, cuda_device, graphs)
    torch.cuda.synchronize()
    _assert_same_fit(captured, eager)
    assert graphs.captured == (3 if dual else 2)
    nets = 4 if dual else 2
    assert K.launches["fwd"] == K.launches["bwd"] == nets * 50


def test_captured_video_axis_fit_and_its_resume(cuda_device):
    """The V = 2 fit: captured equals eager across the phase switch; the
    captured fit resumed from its checkpoint state at an eval point (params,
    Adam moments, generator state) ends where the uninterrupted one ends;
    launches read 2 x steps with the video axis."""
    import dataclasses

    from deflicker_torch.atlas.graphs import FitGraphs
    from deflicker_torch.atlas.multifit import fit_atlas_multi

    cfg, specs, data, params = _fit_case(cuda_device, V=2)
    cfg = dataclasses.replace(cfg, iters_num=40, evaluate_every=24)
    eager = _run_fit(params, specs, data, cfg, cuda_device,
                     FitGraphs(eager=True), V=2)
    K.reset_launches()
    saved = {}

    def keep(done, st):
        if done == 25:
            saved.update(
                params_v={k: [{kk: t.detach().clone() for kk, t in l.items()}
                              for l in v] for k, v in st["params_v"].items()},
                opt_state_v=st["opt_state_v"],
                generator_state=st["generator_state"].clone())

    captured = _run_fit(params, specs, data, cfg, cuda_device, V=2,
                        checkpoint_callback=keep)
    torch.cuda.synchronize()
    assert K.launches["fwd_v"] == K.launches["bwd_v"] == 2 * 40
    _assert_same_fit(captured, eager)

    gen = torch.Generator(device=cuda_device)
    gen.set_state(saved["generator_state"])
    p = _clone(saved["params_v"])
    res = fit_atlas_multi(p, specs, data, cfg, gen, start_iteration=25,
                          opt_state_v=saved["opt_state_v"])
    for x, y in zip([t for n in sorted(p) for l in p[n] for t in l.values()],
                    [t for n in sorted(captured[0]) for l in captured[0][n]
                     for t in l.values()]):
        assert torch.equal(x, y)
    assert torch.equal(gen.get_state(), captured[3])
    assert res[0].opt_state["step"] == 40


@pytest.mark.parametrize("V", [None, 3])
def test_captured_pretrain_equals_the_eager_pretrain(V, cuda_device):
    """The pretrain (one graph replayed sweeps x frames times, the frame a
    device counter) equals the eager pretrain bit for bit: params and the
    generator's state."""
    from deflicker_torch.atlas import engine as E
    from deflicker_torch.atlas.graphs import FitGraphs
    from deflicker_torch.atlas.multifit import pretrain_mapping_multi

    _, specs, data, params = _fit_case(cuda_device, V=V)
    out = []
    for eager in (True, False):
        p = _clone(params)["mapping1"]
        gen = torch.Generator(device=cuda_device).manual_seed(1)
        graphs = FitGraphs(eager=eager)
        run = E.pretrain_mapping if V is None else pretrain_mapping_multi
        run(p, specs.mapping1, gen, 6, 40, 56, 0.8, pretrain_iters=4,
            batch=3000, graphs=graphs)
        out.append((p, gen.get_state(), graphs.captured))
    assert out[1][2] == 1 and out[0][2] == 0
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    assert torch.equal(out[0][1], out[1][1])


def test_kept_graphs_replay_a_second_fit_of_the_shape(cuda_device):
    """Kept graphs (a `Deflickerer`'s): a second fit of the same shape
    from other data, params and seed captures nothing and equals that fit
    run eagerly."""
    import dataclasses

    from deflicker_torch.atlas.graphs import FitGraphs

    cfg, specs, data, params = _fit_case(cuda_device)
    cfg = dataclasses.replace(cfg, iters_num=30)
    kept = FitGraphs(keep=True)
    _run_fit(params, specs, data, cfg, cuda_device, kept)
    assert kept.captured == 2
    _, _, data2, params2 = _fit_case(cuda_device, seed=1)
    second = _run_fit(params2, specs, data2, cfg, cuda_device, kept)
    assert kept.captured == 2
    _assert_same_fit(second, _run_fit(params2, specs, data2, cfg, cuda_device,
                                      FitGraphs(eager=True)))


def test_captured_fit_under_the_profiler(cuda_device):
    """A fit captured under torch.profiler (DEFLICKER_PROFILE's window):
    the capture succeeds and the trace holds the chain kernels of the
    replays."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    cfg, specs, data, params = _fit_case(cuda_device)
    cfg = dataclasses.replace(cfg, iters_num=12, stop_global_rigidity=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_fit(params, specs, data, cfg, cuda_device)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("chain_fwd_kernel" in n for n in names) >= 2 * 12, len(names)


# ---------------------------------------------------------------------------
# the RAFT solve and the refinement step as CUDA graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body", ["band", "shared", "resident"])
def test_captured_solve_is_bit_equal_to_raft_flow(body, cuda_device,
                                                  monkeypatch):
    """`RAFTFlow.compute_batch` on the card (bf16, 20 iterations, 3 pairs x
    2 directions at 96x128) under each correlation body: the first solve
    eager, then the capture, then replays; every flow equals the eager
    `raft_flow` of the same batch bit for bit, and after the capture the
    body's lookups read 20 a replay (none counted by the capture)."""
    from deflicker_torch.flow import RAFTFlow

    monkeypatch.delenv("DEFLICKER_CORR_SHARED", raising=False)
    monkeypatch.delenv("DEFLICKER_CORR_RESIDENT", raising=False)
    if body != "band":
        monkeypatch.setenv(f"DEFLICKER_CORR_{body.upper()}", "1")
    model = traft.raft_init(torch.Generator().manual_seed(0))
    eng = RAFTFlow(model=model, device=cuda_device)
    rng = np.random.default_rng(2)
    key = {"band": "lookup", "shared": "lookup_shared",
           "resident": "lookup_resident"}[body]
    for n in range(4):
        a = rng.integers(0, 256, (6, 96, 128, 3)).astype(np.float32)
        b = np.roll(a, 3, axis=2)
        C.reset_launches()
        got = eng.compute_batch(a, b)
        torch.cuda.synchronize()
        assert C.launches[key] == 20 and eng.graphs.captured == 1
        _, want = traft.raft_flow(eng.model, torch.from_numpy(a).to(cuda_device),
                                  torch.from_numpy(b).to(cuda_device),
                                  dtype=torch.bfloat16)
        np.testing.assert_array_equal(got, want.cpu().numpy())
    C.reset_launches()


def _pageable_flow(eng, a, b):
    """`compute_batch`'s values by the pageable route: each batch through
    `torch.from_numpy(...).to(device)`, rounded and clamped in bf16, the
    flows back through `.cpu()`."""
    from deflicker_torch.ops.pad import Padder

    padder = Padder(*a.shape[1:3], divisor=8, mode="sintel")
    x1, x2 = (padder.pad(torch.from_numpy(x).to(eng.device).round()
                         .clamp_(0, 255)) for x in (a, b))
    return padder.unpad(eng._solve(x1, x2)).cpu().numpy()


# frame sizes of the staged-transfer tests: one padded to 264 x 456, then
# the flow cell's 432 x 768
STAGED_SIZES = ((260, 452), (432, 768))


@pytest.mark.parametrize("capture", [True, False])
def test_staged_transfers_equal_the_pageable_route(capture, cuda_device):
    """`compute_batch` on the card, its frames through the pinned staging
    and its flows back into pinned memory, against the pageable route on
    the same engine: bit-equal, with the solves captured and eager, at
    batches of 8 and 6 directions and two frame sizes (the second larger,
    so the staging grows); the callers' fractional frames are left as they
    were.  `flow.staging_made` grows at the larger size and
    not at either tail; the first call's flows are unchanged after every
    later call (no array aliases memory a later call rewrites)."""
    from deflicker_torch.flow import RAFTFlow
    from deflicker_torch.utils import trace

    model = traft.raft_init(torch.Generator().manual_seed(0))
    eng = RAFTFlow(model=model, iters=4, device=cuda_device, capture=capture)
    rng = np.random.default_rng(3)
    first = kept = None
    made = []
    for H, W in STAGED_SIZES:
        for B in (8, 6):
            before = trace.counters().get("flow.staging_made", 0)
            for _ in range(2):
                a = rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
                b = np.roll(a, 3, axis=2)
                a0, b0 = a.copy(), b.copy()
                got = eng.compute_batch(a, b)
                np.testing.assert_array_equal(a, a0)
                np.testing.assert_array_equal(b, b0)
                np.testing.assert_array_equal(got, _pageable_flow(eng, a, b))
                assert got.shape == (B, H, W, 2) and got.dtype == np.float32
                if first is None:
                    first, kept = got, got.copy()
            made.append(trace.counters().get("flow.staging_made", 0) - before)
    np.testing.assert_array_equal(first, kept)
    assert made[0] > 0 and made[1] == 0 and made[2] > 0 and made[3] == 0, made
    assert eng.graphs.captured == (4 if capture else 0)


@pytest.mark.parametrize("V", [1, 2])
def test_captured_refinement_is_bit_equal_to_the_eager_one(V, cuda_device):
    """`FilterEngine.refine` on the card (bf16, span 4) over spans of 4, 4
    and a ragged 2 frames, with V = 2 one video ending inside the second
    span: refined frames and carries bit-equal to `refine_span_multi`; one
    graph, captured after the first frame."""
    from deflicker_torch.filter import engine as F
    from deflicker_torch.models import transformnet_init, unet_init

    gen = torch.Generator().manual_seed(2)
    eng = F.FilterEngine(unet_init(gen), transformnet_init(gen),
                         device=cuda_device, dtype=torch.bfloat16, span=4)
    frames = torch.rand((V, 10, 64, 96, 3), generator=gen).to(cuda_device)
    lengths = [10, 6][:V]
    carry = ref = (frames[:, 0], frames[:, 0])
    for s0, s1 in ((0, 4), (4, 8), (8, 10)):
        body = frames[:, s0:s1]
        nv = [int(np.clip(L - s0, 0, s1 - s0)) for L in lengths]
        carry, got = eng.refine(carry, body, nv)
        ref, want = F.refine_span_multi(eng.tnet, ref, body, nv,
                                        torch.bfloat16)
        assert torch.equal(got, want)
        assert all(torch.equal(x, y) for x, y in zip(carry, ref))
    assert eng.graphs.captured == 1


# ---------------------------------------------------------------------------
# stage-2 training and the NCCL sharded fit as CUDA graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", ["filter", "refiner"])
def test_captured_training_equals_eager_training(net, dtype, cuda_device):
    """12 steps of each net with a texture bank (both clip kinds drawn),
    captured (one graph a kind) and eager (`FitGraphs(eager=True)`) from
    one seed: chunk logs and params bit-equal."""
    import dataclasses

    from deflicker_torch.atlas.graphs import FitGraphs
    from deflicker_torch.models import unet_init
    from deflicker_torch.train import stage2_trainer as T

    cfg = T.TrainConfig(height=64, width=64, batch=2, clip_len=3,
                        clip_batch=2, steps_per_call=4, dtype=dtype,
                        filter_steps=12, refine_steps=12)
    bank = np.random.default_rng(0).uniform(0, 1, (4, 128, 128, 3)).astype(
        np.float32)
    frozen = unet_init(torch.Generator().manual_seed(5))
    runs = {}
    for route in ("eager", "captured"):
        graphs = FitGraphs(eager=route == "eager")
        if net == "filter":
            model, logs = T.train_filter(cfg, 2, None, bank, cuda_device,
                                         graphs)
        else:
            model, logs = T.train_refiner(cfg, 2, frozen, None, bank,
                                          cuda_device, graphs)
        runs[route] = (model.state_dict(), logs, graphs.captured)
    assert runs["eager"][1] == runs["captured"][1]
    for a, b in zip(runs["eager"][0].values(), runs["captured"][0].values()):
        assert torch.equal(a, b)
    assert (runs["eager"][2], runs["captured"][2]) == (0, 2)


def test_captured_sharded_fit_under_nccl(cuda_device):
    """The sample-sharded fit at world size 1 under NCCL, captured (its
    all-reduce inside the graphs) and eager, against the captured
    unsharded fit: all three bit-equal; one graph a loss phase."""
    import dataclasses

    import torch.distributed as dist

    from deflicker_torch.atlas.graphs import FitGraphs
    from deflicker_torch.parallel import make_mesh
    from deflicker_torch.parallel.mesh import free_port

    cfg, specs, data, params = _fit_case(cuda_device)
    cfg = dataclasses.replace(cfg, iters_num=30)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        assert mesh.backend == "nccl"
        graphs = FitGraphs()
        captured = _run_fit(params, specs, data, cfg, cuda_device, graphs,
                            mesh=mesh)
        eager = _run_fit(params, specs, data, cfg, cuda_device,
                         FitGraphs(eager=True), mesh=mesh)
    finally:
        dist.destroy_process_group()
    unsharded = _run_fit(params, specs, data, cfg, cuda_device, FitGraphs())
    _assert_same_fit(captured, eager)
    _assert_same_fit(captured, unsharded)
    assert graphs.captured == 2
