"""Checkpoint save/load for param/optimizer trees.

Same role as the reference's torch.save checkpoint dict (models + optimizer
+ iteration in one file), serialized as a pickled tree of plain numpy
arrays — the format the JAX package writes, so a checkpoint loads with
pickle and numpy alone.  The port's checkpoints hold only numpy and Python
scalars (no torch objects).
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any

import numpy as np
import torch


def to_host(tree: Any) -> Any:
    """Tensor tree -> numpy tree: every tensor leaf becomes an owned copy
    (`.detach().cpu().numpy()` of a clone), so later in-place optimizer
    updates can never show through a saved checkpoint."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone().numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return np.array(tree, copy=True)
    return tree


def save_checkpoint(path: str | Path, tree: Any) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(to_host(tree), f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)        # atomic on POSIX: a crash never corrupts the ckpt
    return path


class _PlainUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays and Python builtins only.  A checkpoint that
    names any other class (the JAX package's fit checkpoints pickle optax
    optimizer states) is refused instead of importing that class's
    package."""

    _BUILTINS = {"dict", "list", "tuple", "int", "float", "bool", "str",
                 "complex", "bytes", "bytearray", "set", "frozenset", "slice"}

    def find_class(self, module, name):
        if module == "numpy" or module.startswith(("numpy.", "numpy._")):
            return super().find_class(module, name)
        if module == "builtins" and name in self._BUILTINS:
            return super().find_class(module, name)
        if (module, name) == ("collections", "OrderedDict"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint holds {module}.{name}: only plain numpy checkpoints "
            "load here (resuming from a JAX-package fit checkpoint, whose "
            "opt_state pickles optax classes, is not supported)")


def load_checkpoint(path: str | Path) -> Any:
    with open(path, "rb") as f:
        return _PlainUnpickler(f).load()
