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
    reference at inference) are skipped;
  * `raft_state_from_flax`: the JAX package's RAFT variables
    {"params", "batch_stats"} -> a state dict under the reference's torch
    keys, the inverse of deflicker_tpu/flow/convert.py; and
    `raft_variables_from_state_dict`, the way back, which writes the
    converted file both packages read.
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
    """Load stage-2 weights into `module`: the reference's torch `.pth`/`.pt`
    (filter/convert.py) or a shipped `.ckpt` (pickled flax tree of numpy);
    every key must match (strict)."""
    if Path(path).suffix in (".pth", ".pt"):
        from ..filter.convert import read_stage2_pth

        state = read_stage2_pth(path)
    else:
        from .checkpoint import load_checkpoint

        state = stage2_from_flax(load_checkpoint(path))
    module.load_state_dict(state, strict=True)
    return module


def _raft_module_names(flax_name: str) -> list:
    """The reference's name(s) of one flax RAFT submodule.  A block's
    `norm3` is also entry 1 of its `downsample` Sequential in the reference,
    so its parameters stand under both names in a state dict."""
    if flax_name == "downsample_conv":
        return ["downsample.0"]
    if flax_name == "norm3":
        return ["norm3", "downsample.1"]
    return [_torch_name(flax_name)]


def raft_state_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """RAFT flax variables {"params", "batch_stats"} (numpy leaves) -> a
    torch state dict that `models.raft.RAFT` loads with strict=True.

      params/<m>/kernel (HWIO)        -> <m>.weight (OIHW)
      params/<m>/bias                 -> <m>.bias
      params/<m>/bn/{scale,bias}      -> <m>.{weight,bias}
      batch_stats/<m>/bn/{mean,var}   -> <m>.running_{mean,var}
      layerN_M -> layerN.M, mask_0/mask_2 -> mask.0/.2,
      downsample_conv -> downsample.0, norm3 -> norm3 and downsample.1

    Every batch norm also gets the `num_batches_tracked` buffer torch keeps
    (0; inference never reads it).  Any other leaf raises."""
    leaf_names = {("params", "kernel"): "weight", ("params", "bias"): "bias",
                  ("params", "bn", "scale"): "weight",
                  ("params", "bn", "bias"): "bias",
                  ("batch_stats", "bn", "mean"): "running_mean",
                  ("batch_stats", "bn", "var"): "running_var"}
    out: Dict[str, torch.Tensor] = {}

    def put(prefixes, leaf, value):
        for prefix in prefixes:
            out[f"{prefix}.{leaf}"] = value.clone()

    def walk(node, kind, prefixes):
        for key, val in node.items():
            if key == "bn":
                for stat, v in val.items():
                    leaf = leaf_names.get((kind, "bn", stat))
                    if leaf is None:
                        raise KeyError(f"unexpected leaf {prefixes[0]}/bn/{stat}")
                    put(prefixes, leaf, torch.from_numpy(
                        np.array(v, dtype=np.float32)))
                put(prefixes, "num_batches_tracked",
                    torch.zeros((), dtype=torch.long))
            elif isinstance(val, Mapping):
                walk(val, kind, [f"{p}.{n}" if p else n for p in prefixes
                                 for n in _raft_module_names(key)])
            else:
                leaf = leaf_names.get((kind, key))
                if leaf is None:
                    raise KeyError(f"unexpected leaf {prefixes[0]}/{key}")
                v = np.array(val, dtype=np.float32)
                if key == "kernel":
                    if v.ndim != 4:
                        raise ValueError(f"expected a conv kernel at "
                                         f"{prefixes[0]}: {v.shape}")
                    v = np.ascontiguousarray(v.transpose(3, 2, 0, 1))
                put(prefixes, leaf, torch.from_numpy(v))

    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected collections {sorted(unknown)}")
    walk(variables["params"], "params", [""])
    walk(variables.get("batch_stats", {}), "batch_stats", [""])
    return out


def _set(tree: Dict, path, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _module_path(parts) -> list:
    merged = []
    for p in parts:
        if p.isdigit():
            merged[-1] = f"{merged[-1]}_{p}"
        else:
            merged.append(p)
    fixups = {"downsample_0": "downsample_conv", "downsample_1": "norm3"}
    return [fixups.get(m, m) for m in merged]


def raft_variables_from_state_dict(state_dict: Mapping) -> Dict:
    """Reference-keyed torch state dict -> {"params", "batch_stats"} of
    numpy, the layout of the JAX package's converted RAFT file (conv weights
    OIHW -> HWIO kernels, batch norms under `bn`, `layerN.M` -> `layerN_M`,
    `downsample.0/.1` -> `downsample_conv`/`norm3`, `mask.0/.2` ->
    `mask_0`/`mask_2`).  The inverse of `utils.convert.raft_state_from_flax`."""
    norm_leaves = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                   "running_mean": ("batch_stats", "mean"),
                   "running_var": ("batch_stats", "var")}
    out: Dict = {"params": {}, "batch_stats": {}}
    for key, val in state_dict.items():
        *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        path = _module_path(mods)
        v = val.detach().cpu().float().numpy()
        if path[-1].startswith("norm"):
            if leaf not in norm_leaves:
                raise KeyError(f"unexpected norm leaf: {key}")
            kind, name = norm_leaves[leaf]
            _set(out[kind], path + ["bn", name], v)
        elif leaf == "weight":
            if v.ndim != 4:
                raise ValueError(f"expected a 4-D conv weight at {key}: {v.shape}")
            _set(out["params"], path + ["kernel"],
                 np.ascontiguousarray(v.transpose(2, 3, 1, 0)))
        elif leaf == "bias":
            _set(out["params"], path + ["bias"], v)
        else:
            raise KeyError(f"unexpected leaf: {key}")
    return out
