"""deflicker_torch — the PyTorch/CUDA port of deflicker_tpu for NVIDIA Hopper.

Same pipeline, artifact tree and reference-JSON config as the JAX package:
host I/O, foreground masks, Farneback or RAFT flow, the stage-1 neural-atlas
fit, single or dual (its fused IMLP chain runs as hand-written CUDA kernels,
`ops/cuda`), the atlas render and texture export, the stage-2 neural filter
and local refinement, and the metrics.  Importing the
package builds nothing and touches no device; entry points take a `device`
(default ``"cuda"``) and raise when no CUDA device is present unless the
caller asks for ``device="cpu"``.  `Deflickerer` (api.py) keeps one
card's networks and kernels warm across many videos;
`DEFLICKER_DEBUG_NANS=1` turns on autograd's anomaly detection at import
(utils/debug.py).
"""

__version__ = "0.1.0"


def _enable_numerics_debug_from_env() -> None:
    """DEFLICKER_DEBUG_NANS=1: the sanitizer mode (utils/debug.py)."""
    import os

    if os.environ.get("DEFLICKER_DEBUG_NANS") == "1":
        from .utils.debug import enable_numerics_debug

        enable_numerics_debug()


_enable_numerics_debug_from_env()


def __getattr__(name):
    # lazy: `from deflicker_torch import Deflickerer` without importing the
    # pipeline at package import
    if name == "Deflickerer":
        from .api import Deflickerer

        return Deflickerer
    raise AttributeError(f"module 'deflicker_torch' has no attribute {name!r}")
