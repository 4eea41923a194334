"""RAFT checkpoints -> a loaded `models.raft.RAFT`.

Two formats, the two the JAX package reads (deflicker_tpu/flow/convert.py):

  * the reference's torch `raft-things.pth` / `.pt` state dict, bare or
    under a `state_dict` key, with or without the `module.` prefix of its
    DataParallel shell (src/models/stage_1/raft_wrapper.py:22-25): the
    port's modules carry the reference's names, so it loads as it is;
  * the JAX package's pre-converted pickled variables (`utils/checkpoint`
    format: {"params", "batch_stats"} of numpy), carried across by
    `utils.convert.raft_state_from_flax`.

Either way every key must land (strict).
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..models.raft import RAFT
from ..utils.checkpoint import load_checkpoint
from ..utils.convert import raft_state_from_flax


def load_raft_checkpoint(path: str | Path) -> RAFT:
    """A RAFT (float32, on the CPU, eval mode) holding the weights at
    `path`, in either format."""
    path = Path(path)
    if path.suffix in (".pth", ".pt"):
        sd = torch.load(str(path), map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
    else:
        sd = raft_state_from_flax(load_checkpoint(path))
    model = RAFT()
    model.load_state_dict(sd, strict=True)
    return model
