"""deflicker_torch — the PyTorch/CUDA port of deflicker_tpu for NVIDIA Hopper.

Same pipeline, artifact tree and reference-JSON config as the JAX package:
host I/O and Farneback flow, the stage-1 neural-atlas fit (its fused IMLP
chain runs as hand-written CUDA kernels, `ops/cuda`), the atlas render, the
stage-2 neural filter and local refinement, and the metrics.  Importing the
package builds nothing and touches no device; entry points take a `device`
(default ``"cuda"``) and raise when no CUDA device is present unless the
caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
