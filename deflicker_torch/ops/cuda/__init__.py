"""Hand-written CUDA kernels (sources in `deflicker_torch/csrc/`), their
plain PyTorch twins and the autograd glue.  Nothing builds at import."""

from .imlp_kernel import (fused_imlp_linear_chain, imlp_chain_bwd_cuda,
                          imlp_chain_bwd_plain, imlp_chain_fwd_cuda,
                          imlp_chain_fwd_plain, launches, reset_launches)

__all__ = ["fused_imlp_linear_chain", "imlp_chain_bwd_cuda",
           "imlp_chain_bwd_plain", "imlp_chain_fwd_cuda",
           "imlp_chain_fwd_plain", "launches", "reset_launches"]
