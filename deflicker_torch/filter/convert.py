"""The reference's stage-2 checkpoints (`neural_filter.pth`,
`local_refinement_net.pth`): torch state dicts of its UNet and
TransformNet, saved from DataParallel (keys under `module.`), sometimes
inside a `{"state_dict": ...}` dict.

The port's modules use the reference's keys, so a `.pth` loads into them
directly (`read_stage2_pth`, through `utils.convert.load_stage2_module`)
once the wrapper and prefix are gone and the TransformNet's InstanceNorm
entries (`norm_layer`, never applied by the reference at inference, see
models/refine.py) are dropped.
`variables_from_state_dict` writes the flax-layout `{"params": ...}` tree
of numpy (HWIO kernels, `ResBlocks.0` -> `ResBlocks_0`) that the shipped
`pretrained_weights/*.ckpt` files hold and that both packages read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch


def stage2_state_dict(state: Mapping) -> Dict[str, torch.Tensor]:
    """A reference stage-2 checkpoint's dict -> the state dict the port's
    UNet or TransformNet loads with strict=True."""
    if isinstance(state, Mapping) and "state_dict" in state:
        state = state["state_dict"]
    out = {}
    for key, val in state.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if "norm_layer" in key or key.endswith("num_batches_tracked"):
            continue
        out[key] = val
    return out


def read_stage2_pth(path: str | Path) -> Dict[str, torch.Tensor]:
    """The cleaned state dict of a `.pth` (tensors only, on the CPU)."""
    return stage2_state_dict(torch.load(str(path), map_location="cpu",
                                        weights_only=True))


def variables_from_state_dict(state: Mapping) -> Dict:
    """A cleaned stage-2 state dict -> {"params": ...} of numpy: conv
    weights OIHW -> HWIO kernels, biases as they are, `ResBlocks.0` ->
    `ResBlocks_0`."""
    from ..utils.convert import _module_path, _set

    params: Dict = {}
    for key, val in state.items():
        *mods, leaf = key.split(".")
        path = _module_path(mods)
        v = val.detach().cpu().numpy()
        if leaf == "weight":
            if v.ndim != 4:
                raise ValueError(f"expected a conv weight at {key}: {v.shape}")
            _set(params, path + ["kernel"],
                 np.ascontiguousarray(v.transpose(2, 3, 1, 0)))
        elif leaf == "bias":
            _set(params, path + ["bias"], np.array(v, copy=True))
        else:
            raise KeyError(f"unexpected leaf: {key}")
    return {"params": params}
