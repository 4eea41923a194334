"""Port vs JAX package: the IMLP and the fused chain (plain twin of the CUDA
kernel on the CPU; the JAX side runs its Pallas kernel in interpret mode
with the production bodies: bf16 compute, v2, pipe)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflicker_tpu.models import imlp as jimlp
from deflicker_tpu.ops.pallas.imlp_kernel import fused_imlp_linear_chain as jchain

from deflicker_torch.models import imlp as timlp
from deflicker_torch.ops.cuda import imlp_kernel as K
from deflicker_torch.utils.convert import imlp_params_from_jax

torch.set_num_threads(2)


# narrow copies of the fit's two networks
SPECS = {
    "mapping": dict(input_dim=3, output_dim=2, hidden_dim=64,
                    use_positional=False, num_layers=6, skip_layers=()),
    "atlas": dict(input_dim=2, output_dim=3, hidden_dim=64,
                  use_positional=True, positional_dim=10, num_layers=8,
                  skip_layers=(4, 7)),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _specs(name):
    return jimlp.IMLPSpec(**SPECS[name]), timlp.IMLPSpec(**SPECS[name])


def _setup(name, B, seed):
    jspec, tspec = _specs(name)
    jparams = jimlp.imlp_init(jax.random.key(seed), jspec)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, jspec.input_dim)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (B, jspec.output_dim)).astype(np.float32)
    host = [{k: np.asarray(v) for k, v in l.items()} for l in jparams]
    return jspec, tspec, jparams, host, x, tgt


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _jax_chain_grads(jspec, jparams, x, tgt, cdt):
    def loss(p, xx):
        xe = (jimlp.positional_encoding(xx, jspec.positional_dim)
              if jspec.use_positional else xx)
        y = jnp.tanh(jchain(p, xe, jspec, tile=128, interpret=True,
                            compute_dtype=cdt, v2=True, pipe=True))
        return jnp.sum(y * tgt), y

    (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(x))
    return np.asarray(y), gp, np.asarray(gx)


def _torch_chain_grads(tspec, host, x, tgt, tdt):
    params = imlp_params_from_jax(host)
    xt = torch.tensor(x, requires_grad=True)
    y = timlp.imlp_apply_fused(params, xt, tspec, compute_dtype=tdt)
    (y * torch.tensor(tgt)).sum().backward()
    return y.detach().numpy(), params, xt.grad.numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(SPECS))
def test_fused_chain_matches_pallas(name, dtype):
    """Forward, param grads and input grads of the port's chain (plain twin)
    vs the Pallas chain.  f32: both sides are exact-operand f32 products, so
    only summation order differs (rtol 1e-4).  bf16: the same bf16-rounded
    operands with f32 accumulation; a different f32 sum can round a bf16
    activation or gradient the other way, so the bound is a relative
    Frobenius error of 5e-3 (forward) and 2e-2 (grads)."""
    jdt, tdt = DTYPES[dtype]
    jspec, tspec, jparams, host, x, tgt = _setup(name, 300, 1)
    y_j, gp_j, gx_j = _jax_chain_grads(jspec, jparams, x, tgt, jdt)
    y_t, params_t, gx_t = _torch_chain_grads(tspec, host, x, tgt, tdt)
    pairs = [(gx_t, gx_j)]
    for lt, lj in zip(params_t, gp_j):
        pairs += [(lt["w"].grad.numpy(), lj["w"]), (lt["b"].grad.numpy(), lj["b"])]
    if dtype == "f32":
        np.testing.assert_allclose(y_t, y_j, rtol=1e-4, atol=1e-6)
        for a, b in pairs:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    else:
        assert _rel(y_t, y_j) < 5e-3
        for a, b in pairs:
            assert _rel(a, b) < 2e-2


def test_skip_branch_gets_no_gradient():
    """The input gradient of the atlas chain flows through layer 0 only, as
    through the reference's detached skip input — and the test can tell:
    a version with a live skip branch gives a different gradient."""
    _, tspec, _, host, x, tgt = _setup("atlas", 64, 2)
    _, _, gx_fused = _torch_chain_grads(tspec, host, x, tgt, torch.float32)

    params = imlp_params_from_jax(host)
    xt = torch.tensor(x, requires_grad=True)
    (timlp.imlp_apply(params, xt, tspec) * torch.tensor(tgt)).sum().backward()
    np.testing.assert_allclose(gx_fused, xt.grad.numpy(), rtol=1e-4, atol=1e-6)

    xt2 = torch.tensor(x, requires_grad=True)
    xe = timlp.positional_encoding(xt2, tspec.positional_dim)
    h = xe
    for i, layer in enumerate(params):
        if i > 0:
            h = torch.relu(h)
        if i in tspec.skip_layers:
            h = torch.cat([h, xe], dim=-1)          # skip branch NOT detached
        h = h @ layer["w"] + layer["b"]
    (torch.tanh(h) * torch.tensor(tgt)).sum().backward()
    assert np.abs(xt2.grad.numpy() - gx_fused).max() > 1e-3


@pytest.mark.parametrize("name", list(SPECS))
def test_imlp_apply_matches_jax(name):
    """Plain f32 IMLP forward and grads vs the JAX package at HIGHEST
    precision (summation order only: rtol 1e-4)."""
    jspec, tspec, jparams, host, x, tgt = _setup(name, 128, 3)

    def jloss(p, xx):
        return jnp.sum(jimlp.imlp_apply(p, xx, jspec) * tgt)

    l_j, (gp_j, gx_j) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jparams, jnp.asarray(x))
    params = imlp_params_from_jax(host)
    xt = torch.tensor(x, requires_grad=True)
    l_t = (timlp.imlp_apply(params, xt, tspec) * torch.tensor(tgt)).sum()
    l_t.backward()
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-4,
                               atol=1e-5)
    for lt, lj in zip(params, gp_j):
        np.testing.assert_allclose(lt["w"].grad.numpy(), np.asarray(lj["w"]),
                                   rtol=1e-4, atol=1e-5)


def test_positional_encoding_order():
    """Frequency-major sin/cos layout, equal to the JAX encoding to f32
    rounding of sin/cos (atol 1e-5 at 2^9·pi arguments)."""
    x = np.random.default_rng(4).uniform(-1, 1, (50, 3)).astype(np.float32)
    e_j = np.asarray(jimlp.positional_encoding(jnp.asarray(x), 10))
    e_t = timlp.positional_encoding(torch.tensor(x), 10).numpy()
    assert e_t.shape == (50, 60)
    np.testing.assert_allclose(e_t, e_j, atol=1e-5)
    # the first six entries are sin(pi x0..x2), cos(pi x0..x2)
    np.testing.assert_allclose(e_t[:, :3], np.sin(np.pi * x), atol=1e-6)
    np.testing.assert_allclose(e_t[:, 3:6], np.cos(np.pi * x), atol=1e-6)


def test_ragged_batch():
    """A batch that is no tile multiple (77 rows; the Pallas wrapper pads to
    its tile, the CUDA kernel masks the edge) agrees with the JAX chain
    (bf16 bound as above)."""
    jspec, tspec, jparams, host, x, tgt = _setup("atlas", 77, 5)
    y_j, _, gx_j = _jax_chain_grads(jspec, jparams, x, tgt, jnp.bfloat16)
    y_t, _, gx_t = _torch_chain_grads(tspec, host, x, tgt, torch.bfloat16)
    assert y_t.shape == (77, 3)
    assert _rel(y_t, y_j) < 5e-3 and _rel(gx_t, gx_j) < 2e-2


def test_init_bounds_and_seed():
    """torch-Linear init: W and b in ±1/sqrt(fan_in); one seed, one init."""
    _, tspec = _specs("atlas")
    a = timlp.imlp_init(tspec, torch.Generator().manual_seed(0))
    b = timlp.imlp_init(tspec, torch.Generator().manual_seed(0))
    for (fi, fo), la, lb in zip(tspec.layer_dims(), a, b):
        assert la["w"].shape == (fi, fo) and la["b"].shape == (fo,)
        assert float(la["w"].detach().abs().max()) <= fi ** -0.5
        assert float(la["b"].detach().abs().max()) <= fi ** -0.5
        assert torch.equal(la["w"], lb["w"])


def test_cpu_tensor_takes_plain_twin():
    """On CPU tensors the autograd Function runs the plain twins (no kernel
    launch is counted); the CUDA wrappers refuse CPU tensors."""
    _, tspec, _, host, x, tgt = _setup("mapping", 40, 6)
    K.reset_launches()
    _torch_chain_grads(tspec, host, x, tgt, torch.bfloat16)
    assert K.launches == {"fwd": 0, "bwd": 0}
    ws = [torch.tensor(l["w"]).to(torch.bfloat16) for l in host]
    bs = [torch.tensor(l["b"]) for l in host]
    with pytest.raises(ValueError):
        K.imlp_chain_fwd_cuda(torch.tensor(x), ws, bs, ())

