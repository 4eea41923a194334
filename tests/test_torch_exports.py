"""The port's package-level names against the JAX package's, and the
run-to-run reproducibility of stage-2 training's backward (the refiner's
reflection pad, the warp it goes through, cuDNN's f32 algorithms)."""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from deflicker_tpu.ops.sampling import flow_warp as jflow_warp

from deflicker_torch.models.refine import _reflect_pad, transformnet_init
from deflicker_torch.ops.sampling import flow_warp

torch.set_num_threads(2)

# every subpackage of deflicker_tpu with an __all__; ops/pallas holds the
# TPU kernels, which the port replaces under ops/cuda
SUBPACKAGES = ["atlas", "cli", "config", "filter", "flow", "io", "losses",
               "metrics", "models", "ops", "parallel", "seg", "train", "utils"]


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_port_exports_every_jax_name(name):
    """`from deflicker_torch.<pkg> import X` works for every X the JAX
    package's <pkg> exports: the JAX `__all__` is inside the port's, and
    every listed name resolves."""
    jax_pkg = importlib.import_module(f"deflicker_tpu.{name}")
    port = importlib.import_module(f"deflicker_torch.{name}")
    missing = sorted(set(jax_pkg.__all__) - set(port.__all__))
    assert not missing, missing
    for attr in port.__all__:
        assert getattr(port, attr) is not None, attr


def test_renamed_exports_are_the_port_functions():
    """The four JAX names the port had under other names are aliases."""
    from deflicker_torch import filter as tfilter
    from deflicker_torch import flow as tflow
    from deflicker_torch import models as tmodels
    from deflicker_torch.filter.convert import variables_from_state_dict
    from deflicker_torch.utils.convert import (load_stage2_module,
                                               raft_variables_from_state_dict)

    assert tfilter.convert_conv_state_dict is variables_from_state_dict
    assert tfilter.load_stage2_checkpoint is load_stage2_module
    assert tflow.convert_raft_state_dict is raft_variables_from_state_dict
    assert tmodels.RAFTModules is tmodels.RAFT


@pytest.mark.parametrize("p", [1, 2, 4])
def test_reflect_pad_is_f_pad_with_a_fixed_order_backward(p):
    """The refiner's reflection pad (one axis at a time, so that no
    source takes more than two gradients): its forward bit-equal to
    F.pad(..., "reflect"), its gradient equal to F.pad's within f64
    rounding and bit-equal across calls."""
    gen = torch.Generator().manual_seed(p)
    x = torch.randn(2, 3, 9, 11, dtype=torch.float64,
                    generator=gen).requires_grad_()
    ref = F.pad(x, (p, p, p, p), mode="reflect")
    y = _reflect_pad(x, p)
    assert torch.equal(y, ref)
    g = torch.randn(ref.shape, dtype=torch.float64, generator=gen)
    grads = [torch.autograd.grad((_reflect_pad(x, p) * g).sum(), x)[0]
             for _ in range(2)]
    want = torch.autograd.grad((ref * g).sum(), x)[0]
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], want, rtol=0, atol=1e-12)


def test_refiner_gradient_repeats_bit_for_bit():
    """Two backward passes of the TransformNet (reflection pads on every
    conv) on the same input give the same gradients to the bit."""
    gen = torch.Generator().manual_seed(0)
    net = transformnet_init(gen)
    x = torch.rand(2, 12, 32, 32, generator=gen)
    grads = []
    for _ in range(2):
        net.zero_grad()
        (net(x) ** 2).sum().backward()
        grads.append([p.grad.clone() for p in net.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_warp_gradient_repeats_and_matches_jax():
    """The warp of the refiner's temporal loss: its image gradient is the
    same on two calls and equals `jax.grad` of the JAX package's warp
    within 1e-5."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (12, 14, 3)).astype(np.float32)
    flow = (rng.normal(size=(12, 14, 2)) * 3).astype(np.float32)
    w = rng.normal(size=(12, 14, 3)).astype(np.float32)

    def grad_torch():
        x = torch.tensor(img, requires_grad=True)
        (flow_warp(x, torch.tensor(flow)) * torch.tensor(w)).sum().backward()
        return x.grad.numpy()

    a, b = grad_torch(), grad_torch()
    np.testing.assert_array_equal(a, b)
    want = jax.grad(lambda x: jnp.sum(jflow_warp(x, jnp.asarray(flow))
                                      * jnp.asarray(w)))(jnp.asarray(img))
    np.testing.assert_allclose(a, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f32_training_steps_run_with_deterministic_cudnn(dtype):
    """Stage-2 training's f32 steps run with cuDNN's deterministic
    algorithms (its f32 choices made two runs of one seed differ on the
    card; bf16 runs repeat without them); the flag comes back as it
    was."""
    from deflicker_torch.train import stage2_trainer

    before = torch.backends.cudnn.deterministic
    seen, sums = [], {}

    def step(k):
        seen.append(torch.backends.cudnn.deterministic)
        if not sums:
            sums["keys"], sums["vals"] = ["total"], torch.zeros(1)
        sums["vals"].add_(1.0)

    logs = stage2_trainer._run(step, sums, 5, 2, "filter", None, dtype)
    assert seen == [dtype == "float32" or before] * 5
    assert [r["step"] for r in logs] == [2, 4, 5]
    assert torch.backends.cudnn.deterministic == before
