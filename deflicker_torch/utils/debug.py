"""Numerics sanitizer, the counterpart of the JAX package's
`utils/debug.py`.  Both layers are off by default:

  * `enable_numerics_debug()` / `DEFLICKER_DEBUG_NANS=1` turns on
    `torch.autograd.set_detect_anomaly(True)`: every backward checks each
    function's gradients and raises at the first one that returns a NaN,
    naming it with the forward's traceback.  The chain and correlation
    `autograd.Function`s are covered like any other.  It costs a host sync
    per node of the backward, so it is a debugging mode; the always-on
    guard is the finite-loss check and rescue checkpoint of
    `atlas/engine.run_fit_schedule`.
  * `assert_all_finite(tree, name)`: a spot probe over a tree of tensors
    that raises `FloatingPointError` naming `name` when a floating leaf
    holds a NaN or an Inf, and otherwise returns the tree unchanged.
"""

from __future__ import annotations

__all__ = ["enable_numerics_debug", "numerics_debug_enabled",
           "assert_all_finite"]

_ENABLED = False


def numerics_debug_enabled() -> bool:
    return _ENABLED


def enable_numerics_debug() -> None:
    """Turn on autograd's anomaly detection globally.  Idempotent; called at
    package import when DEFLICKER_DEBUG_NANS=1.  Touches no device."""
    global _ENABLED
    if _ENABLED:
        return
    import torch

    torch.autograd.set_detect_anomaly(True)
    _ENABLED = True


def assert_all_finite(tree, name: str = "value"):
    """Raise FloatingPointError if a floating tensor or array of `tree`
    (nested dicts, lists and tuples) holds a non-finite element; return the
    tree unchanged otherwise.  Reads each leaf's verdict back to the host."""
    import numpy as np
    import torch

    def finite(leaf) -> bool:
        if isinstance(leaf, torch.Tensor):
            return (not leaf.is_floating_point()
                    or bool(torch.isfinite(leaf).all()))
        if isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype,
                                                          np.floating):
            return bool(np.isfinite(leaf).all())
        return True

    def walk(node) -> bool:
        if isinstance(node, dict):
            return all(walk(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return all(walk(v) for v in node)
        return finite(node)

    if not walk(tree):
        raise FloatingPointError(
            f"non-finite values detected in {name!r} (DEFLICKER_DEBUG_NANS=1 "
            "turns on autograd's anomaly detection to find the function "
            "that produced them)")
    return tree
