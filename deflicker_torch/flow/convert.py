"""RAFT or GMA checkpoints -> a loaded `models.raft.RAFT` or
`models.gma.GMA`.

Two formats, the two the JAX package reads (deflicker_tpu/flow/convert.py):

  * a torch `.pth` / `.pt` state dict, bare or under a `state_dict` key,
    with or without the `module.` prefix of a DataParallel shell
    (src/models/stage_1/raft_wrapper.py:22-25): the reference's
    `raft-things.pth`, or a GMA checkpoint (zacjiang/GMA `gma-*.pth`),
    told apart by its keys (`att.to_qk.weight`, GMA's attention); the
    port's modules carry the published names, so either loads as it is;
  * the JAX package's pre-converted pickled variables (`utils/checkpoint`
    format: {"params", "batch_stats"} of numpy), RAFT only, carried across
    by `utils.convert.raft_state_from_flax`.

Either way every key must land (strict).
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..models.gma import GMA
from ..models.raft import RAFT
from ..utils.checkpoint import load_checkpoint
from ..utils.convert import raft_state_from_flax


# a key only GMA's state dict has: its attention's query-key projection
GMA_KEY = "att.to_qk.weight"


def load_raft_checkpoint(path: str | Path) -> RAFT:
    """A RAFT or a GMA (float32, on the CPU, eval mode) holding the weights
    at `path`, in either format; the architecture is the one the state
    dict's keys name."""
    path = Path(path)
    if path.suffix in (".pth", ".pt"):
        sd = torch.load(str(path), map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
    else:
        sd = raft_state_from_flax(load_checkpoint(path))
    model = GMA() if GMA_KEY in sd else RAFT()
    model.load_state_dict(sd, strict=True)
    return model
