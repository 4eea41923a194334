"""Weights carried across from the JAX package.

  * `imlp_params_from_jax` / `atlas_params_from_jax`: stage-1 IMLP params
    (lists of {"w": (in, out), "b": (out,)} numpy arrays, the JAX layout
    and the port's) -> tensors that require grad;
  * `stage2_from_flax`: a flax `{"params": ...}` tree of the UNet or the
    TransformNet (the shipped `pretrained_weights/*.ckpt` pickles) -> a
    state dict for the port's modules.  Module names map back to the
    reference's torch keys (`ResBlocks_0` -> `ResBlocks.0`, `upconv4_1` ->
    `upconv4.1`, the inverse of deflicker_tpu/filter/convert.py), conv
    kernels go HWIO -> OIHW, and InstanceNorm keys (never applied by the
    reference at inference) are skipped.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch


def imlp_params_from_jax(layers, device="cpu"):
    return [{"w": torch.tensor(np.asarray(l["w"]), dtype=torch.float32,
                               device=device).requires_grad_(),
             "b": torch.tensor(np.asarray(l["b"]), dtype=torch.float32,
                               device=device).requires_grad_()}
            for l in layers]


def atlas_params_from_jax(params: Mapping, device="cpu") -> Dict[str, list]:
    return {name: imlp_params_from_jax(layers, device)
            for name, layers in params.items()}


def _torch_name(flax_name: str) -> str:
    m = re.fullmatch(r"(.+)_(\d+)", flax_name)
    return f"{m.group(1)}.{m.group(2)}" if m else flax_name


def stage2_from_flax(tree: Mapping, skip_substr=("norm",)) -> Dict[str, torch.Tensor]:
    """flax variables {"params": {...}} -> torch state dict (f32 tensors)."""
    params = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, val in node.items():
            if any(s in key for s in skip_substr):
                continue
            if isinstance(val, Mapping):
                walk(val, path + [_torch_name(key)])
                continue
            v = np.asarray(val, dtype=np.float32)
            if key == "kernel":
                if v.ndim != 4:
                    raise ValueError(f"expected a conv kernel at {path}: {v.shape}")
                out[".".join(path + ["weight"])] = torch.from_numpy(
                    np.ascontiguousarray(v.transpose(3, 2, 0, 1)))
            elif key == "bias":
                out[".".join(path + ["bias"])] = torch.from_numpy(v.copy())
            else:
                raise KeyError(f"unexpected leaf {'/'.join(path + [key])}")

    walk(params, [])
    return out


def load_stage2_module(module: torch.nn.Module, path: str | Path) -> torch.nn.Module:
    """Load a shipped `.ckpt` (pickled flax tree of numpy) into `module`;
    every key must match (strict)."""
    from .checkpoint import load_checkpoint

    module.load_state_dict(stage2_from_flax(load_checkpoint(path)), strict=True)
    return module
