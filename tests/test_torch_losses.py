"""Port vs JAX package: every stage-1 loss term, values and gradients, on the
same numpy inputs (f32, same order of elementwise ops: rtol 1e-5)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflicker_tpu import losses as JL
from deflicker_torch import losses as TL

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
B = 64


def _inputs(seed):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    uv = u(B, 2)
    return {
        "rgb": u(B, 3), "rgb_x": u(B, 3), "rgb_y": u(B, 3),
        "gt": u(B, 3), "dx": u(B, 3), "dy": u(B, 3),
        "uv": uv, "uv_ym": uv + 0.01 * u(B, 2), "uv_xm": uv + 0.01 * u(B, 2),
        "uv_f": uv + 0.05 * u(B, 2), "uv_b": uv + 0.05 * u(B, 2),
        "mf": (rng.uniform(0, 1, B) > 0.3).astype(np.float32),
        "mb": (rng.uniform(0, 1, B) > 0.3).astype(np.float32),
        "alpha": rng.uniform(0.05, 0.95, (B, 1)).astype(np.float32),
        "alpha_f": rng.uniform(0.05, 0.95, (B, 1)).astype(np.float32),
        "alpha_b": rng.uniform(0.05, 0.95, (B, 1)).astype(np.float32),
        "mask": (rng.uniform(0, 1, B) > 0.5).astype(np.float32),
    }


TERMS = {
    "rgb": (lambda L, d: L.rgb_loss(d["rgb"], d["gt"]), "rgb"),
    "gradient": (lambda L, d: L.gradient_loss(d["rgb"], d["rgb_x"], d["rgb_y"],
                                              d["dx"], d["dy"]), "rgb"),
    "rigidity": (lambda L, d: L.rigidity_loss(d["uv"], d["uv_ym"], d["uv_xm"],
                                              1, 192, 0.8), "uv"),
    "global_rigidity": (lambda L, d: L.rigidity_loss(
        d["uv"], d["uv_ym"], d["uv_xm"], 100, 192, 0.8), "uv"),
    "flow": (lambda L, d: L.flow_loss(d["uv"], d["uv_f"], d["uv_b"], d["mf"],
                                      d["mb"], 192, 0.8), "uv"),
    "flow_alpha": (lambda L, d: L.flow_loss(d["uv"], d["uv_f"], d["uv_b"],
                                            d["mf"], d["mb"], 192, 0.8,
                                            alpha=d["alpha"]), "uv"),
    "sparsity": (lambda L, d: L.sparsity_loss(d["rgb"], d["alpha"]), "rgb"),
    "alpha_bootstrap": (lambda L, d: L.alpha_bootstrap_loss(d["alpha"],
                                                            d["mask"]), "alpha"),
    "alpha_flow": (lambda L, d: L.alpha_flow_loss(
        d["alpha"], d["alpha_f"], d["alpha_b"], d["mf"], d["mb"]), "alpha"),
}


@pytest.mark.parametrize("term", list(TERMS))
def test_loss_term_and_grad(term):
    fn, wrt = TERMS[term]
    d = _inputs(0)

    def jloss(v):
        return fn(JL, {**{k: jnp.asarray(a) for k, a in d.items()}, wrt: v})

    lj, gj = jax.value_and_grad(jloss)(jnp.asarray(d[wrt]))
    td = {k: torch.tensor(a) for k, a in d.items()}
    td[wrt].requires_grad_()
    lt = fn(TL, td)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), **TOL)
    # the rigidity gradient goes through (JᵀJ)⁻¹ of a near-identity mapping
    # with 0.01-pixel differences, which scales f32 rounding up ~10x
    gtol = dict(rtol=1e-4, atol=1e-6) if "rigidity" in term else TOL
    np.testing.assert_allclose(td[wrt].grad.numpy(), np.asarray(gj), **gtol)


def test_floors_keep_degenerate_inputs_finite():
    """Collapsed finite differences (uv equal at the offsets) and zero flow
    errors: the det/sqrt floors and safe_norm keep value and gradient
    finite, as in the JAX package."""
    uv = torch.zeros(8, 2, requires_grad=True)
    same = torch.zeros(8, 2)
    l_rig = TL.rigidity_loss(uv, same, same, 1, 192, 0.8)
    l_flow = TL.flow_loss(uv, same, same, torch.ones(8), torch.ones(8), 192, 0.8)
    (l_rig + l_flow).backward()
    assert torch.isfinite(l_rig) and torch.isfinite(l_flow)
    assert torch.isfinite(uv.grad).all()
    lj = JL.rigidity_loss(jnp.zeros((8, 2)), jnp.zeros((8, 2)),
                          jnp.zeros((8, 2)), 1, 192, 0.8)
    np.testing.assert_allclose(l_rig.item(), float(lj), rtol=1e-5)


def test_masked_mean_and_safe_norm():
    v = torch.tensor([1.0, 2.0, 3.0])
    assert TL.masked_mean(v, torch.zeros(3)).item() == 0.0
    assert TL.masked_mean(v, torch.tensor([1.0, 0.0, 1.0])).item() == 2.0
    x = np.random.default_rng(1).normal(size=(10, 2)).astype(np.float32)
    np.testing.assert_allclose(TL.safe_norm(torch.tensor(x)).numpy(),
                               np.asarray(JL.safe_norm(jnp.asarray(x))), **TOL)
