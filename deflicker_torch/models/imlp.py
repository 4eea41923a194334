"""Implicit coordinate MLP (IMLP) — the stage-1 workhorse, as plain
functions over a parameter list (the JAX package's layout: one
{"w": (in, out), "b": (out,)} dict of tensors per layer).

Replicated semantics (reference src/models/stage_1/implicit_neural_networks.py):
  * positional encoding is sin/cos of 2^j * pi * x, frequency-major:
    [sin(f0 x0..xD), cos(f0 x0..xD), sin(f1 x0..xD), ...];
  * skip layers concatenate the encoded input with its gradient stopped
    (the reference's `input = x.detach().clone()`);
  * ReLU before each non-first layer, skip-concat before the layer matmul,
    tanh on the output.

Every function also takes V independent networks of one spec stacked on a
leading video axis — weights (V, in, out), biases (V, out), inputs
(V, ..., input_dim) — the multi-video fit's counterpart of `jax.vmap` over
an IMLP.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class IMLPSpec:
    input_dim: int
    output_dim: int
    hidden_dim: int = 256
    use_positional: bool = True
    positional_dim: int = 10
    skip_layers: Tuple[int, ...] = (4, 6)
    num_layers: int = 8          # includes the output layer
    use_tanh: bool = True
    apply_softmax: bool = False

    @property
    def encoding_dim(self) -> int:
        if self.use_positional:
            return 2 * self.input_dim * self.positional_dim
        return self.input_dim

    def layer_dims(self) -> Sequence[Tuple[int, int]]:
        dims = []
        for i in range(self.num_layers):
            if i == 0:
                fan_in = self.encoding_dim
            elif i in self.skip_layers:
                fan_in = self.hidden_dim + self.encoding_dim
            else:
                fan_in = self.hidden_dim
            fan_out = (self.output_dim if i == self.num_layers - 1
                       else self.hidden_dim)
            dims.append((fan_in, fan_out))
        return dims


def positional_encoding(x: torch.Tensor, positional_dim: int) -> torch.Tensor:
    """x: (..., D) -> (..., 2*D*positional_dim); frequencies 2^j * pi,
    frequency-major order."""
    freqs = (2.0 ** torch.arange(positional_dim, dtype=torch.float32,
                                 device=x.device)) * math.pi
    proj = x[..., None] * freqs                               # (..., D, F)
    enc = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-2)  # (..., 2D, F)
    return enc.transpose(-1, -2).reshape(*x.shape[:-1], -1)


def imlp_init(spec: IMLPSpec, generator: torch.Generator,
              device="cpu", dtype=torch.float32, n_videos: Optional[int] = None):
    """Parameters as torch nn.Linear initializes them: W and b uniform in
    ±1/sqrt(fan_in).  `generator` is a CPU generator, so a seed gives the
    same weights on every device.  `n_videos` = V stacks V networks on a
    leading axis, drawn one whole network after another: network v equals
    the v-th of V successive one-network calls."""
    if n_videos is not None:
        nets = [imlp_init(spec, generator, "cpu", dtype)
                for _ in range(n_videos)]
        return [{k: torch.stack([net[l][k].detach() for net in nets])
                 .to(device).requires_grad_() for k in ("w", "b")}
                for l in range(len(spec.layer_dims()))]
    params = []
    for fan_in, fan_out in spec.layer_dims():
        bound = 1.0 / math.sqrt(fan_in)
        w = (torch.rand((fan_in, fan_out), generator=generator,
                        dtype=dtype) * 2.0 - 1.0) * bound
        b = (torch.rand((fan_out,), generator=generator,
                        dtype=dtype) * 2.0 - 1.0) * bound
        params.append({"w": w.to(device).requires_grad_(),
                       "b": b.to(device).requires_grad_()})
    return params


def is_batched(params) -> bool:
    """True when the layers carry a leading video axis."""
    return params[0]["w"].dim() == 3


def _head(h: torch.Tensor, spec: IMLPSpec) -> torch.Tensor:
    if spec.use_tanh:
        h = torch.tanh(h)
    if spec.apply_softmax:
        h = torch.softmax(h, dim=-1)
    return h


def imlp_apply(params, x: torch.Tensor, spec: IMLPSpec) -> torch.Tensor:
    """The plain f32 IMLP on coordinates x (..., input_dim); with a video
    axis on the params, x is (V, ..., input_dim) and network v reads x[v]."""
    batched = is_batched(params)
    lead = x.shape[:-1]
    if batched:
        x = x.reshape(x.shape[0], -1, x.shape[-1])
    if spec.use_positional:
        x = positional_encoding(x, spec.positional_dim)
    skip_input = x.detach()
    h = x
    for i, layer in enumerate(params):
        if i > 0:
            h = torch.relu(h)
        if i in spec.skip_layers:
            h = torch.cat([h, skip_input.to(h.dtype)], dim=-1)
        h = h @ layer["w"] + (layer["b"][:, None] if batched else layer["b"])
    if batched:
        h = h.reshape(*lead, h.shape[-1])
    return _head(h, spec)


def imlp_apply_fused(params, x: torch.Tensor, spec: IMLPSpec,
                     compute_dtype=torch.bfloat16,
                     stash_bwd: bool = False) -> torch.Tensor:
    """The IMLP through the fused chain kernel (ops/cuda/imlp_kernel):
    positional encoding and the output head here, the matmul chain in the
    kernel (its plain twin for CPU tensors).  bf16 is the fit's
    fit_precision="default" numerics; the kernel computes bf16 only.
    `stash_bwd` picks the stash pair of kernels (the forward writes its
    activations, the backward reads them) over the remat pair.  With a
    video axis on the params (x (V, ..., input_dim)) one kernel launch runs
    all V networks."""
    from ..ops.cuda.imlp_kernel import fused_imlp_linear_chain

    lead = x.shape[:-1]
    if spec.use_positional:
        x = positional_encoding(x, spec.positional_dim)
    rows = (x.shape[0], -1) if is_batched(params) else (-1,)
    h = fused_imlp_linear_chain(params, x.reshape(*rows, x.shape[-1]),
                                spec.skip_layers, compute_dtype, stash_bwd)
    return _head(h.reshape(*lead, -1), spec)
