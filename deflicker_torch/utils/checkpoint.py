"""Checkpoint save/load for param/optimizer trees.

Same role as the reference's torch.save checkpoint dict (models + optimizer
+ iteration in one file), serialized as a pickled tree of plain numpy
arrays — the format the JAX package writes, so a checkpoint loads with
pickle and numpy alone.  The port's checkpoints hold only numpy and Python
scalars (no torch objects).

A fit checkpoint of the JAX package also pickles its optax Adam state,
`(ScaleByAdamState(count, mu, nu), EmptyState())` with numpy leaves.
Those two classes load as the local stand-ins below (optax is never
imported), and `adam_state_from_optax` turns the state into the port's
`{"step", "exp_avg", "exp_avg_sq"}`; every other class is refused.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, NamedTuple

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


class ScaleByAdamState(NamedTuple):
    """Stand-in for optax's Adam moments (the JAX package's fit
    checkpoints): the step count and the first and second moments, trees
    of the params' structure."""

    count: Any
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """Stand-in for optax's stateless transform state (the learning-rate
    scale of `optax.adam`)."""


# the optax classes a JAX-package fit checkpoint pickles, under the modules
# optax defines them in
_OPTAX_CLASSES = {
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.base", "EmptyState"): EmptyState,
}


class _PlainUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays, Python builtins and the two optax classes of
    a JAX-package fit checkpoint (as local stand-ins).  A checkpoint that
    names any other class is refused instead of importing that class's
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
        if (module, name) in _OPTAX_CLASSES:
            return _OPTAX_CLASSES[module, name]
        raise pickle.UnpicklingError(
            f"checkpoint holds {module}.{name}: only plain numpy checkpoints "
            "and the JAX package's optax Adam state load here")


def load_checkpoint(path: str | Path) -> Any:
    with open(path, "rb") as f:
        return _PlainUnpickler(f).load()


def adam_state_from_optax(opt_state: Any, params: Any) -> dict:
    """A JAX-package Adam state, `(ScaleByAdamState(count, mu, nu),
    EmptyState())`, -> the port's host Adam state {"step", "exp_avg",
    "exp_avg_sq"} (what `atlas.engine.adam_state_from_host` reads).

    The moments are taken by structure, network name, layer and "w"/"b", in
    `atlas.engine.flat_params` order of `params` ({net: [{"w", "b"}]}), and
    each must have its parameter's shape.  A group checkpoint's state
    (every leaf with a leading video axis, `count` one per video) maps the
    same way, its step the videos' common count."""
    if not (isinstance(opt_state, tuple) and len(opt_state) == 2
            and isinstance(opt_state[0], ScaleByAdamState)
            and isinstance(opt_state[1], EmptyState)):
        raise ValueError("not an optax.adam state: "
                         f"{type(opt_state).__name__}")
    count, mu, nu = opt_state[0]
    counts = np.unique(np.asarray(count))
    if counts.size != 1:
        raise ValueError(f"videos at different Adam steps: {counts}")
    if set(mu) != set(params) or set(nu) != set(params):
        raise ValueError(f"Adam moments of {sorted(mu)}, params of "
                         f"{sorted(params)}")
    exp_avg, exp_avg_sq = [], []
    for name in sorted(params):
        if not len(mu[name]) == len(nu[name]) == len(params[name]):
            raise ValueError(f"{name}: {len(mu[name])} moment layers, "
                             f"{len(params[name])} parameter layers")
        for m_layer, v_layer, p_layer in zip(mu[name], nu[name], params[name]):
            for k in ("w", "b"):
                m, v = np.asarray(m_layer[k]), np.asarray(v_layer[k])
                if not m.shape == v.shape == tuple(p_layer[k].shape):
                    raise ValueError(f"{name}.{k}: moments {m.shape}, "
                                     f"param {tuple(p_layer[k].shape)}")
                exp_avg.append(m)
                exp_avg_sq.append(v)
    return {"step": int(counts[0]), "exp_avg": exp_avg,
            "exp_avg_sq": exp_avg_sq}


def host_adam_state(opt_state: Any, params: Any) -> Any:
    """The Adam state of a loaded fit checkpoint in the port's form: the
    port's own dict (or None) as it is, a JAX package's optax state through
    `adam_state_from_optax`."""
    if opt_state is None or isinstance(opt_state, dict):
        return opt_state
    return adam_state_from_optax(opt_state, params)
