"""Hand-written CUDA kernels (sources in `deflicker_torch/csrc/`), their
plain PyTorch twins and the autograd glue.  Nothing builds at import.  Each
kernel module has its own `launches` counter and `reset_launches()`."""

from .corr_kernel import corr_lookup_cuda, corr_lookup_plain
from .imlp_kernel import (fused_imlp_linear_chain, imlp_chain_bwd_cuda,
                          imlp_chain_bwd_plain, imlp_chain_fwd_cuda,
                          imlp_chain_fwd_plain, launches, reset_launches)

__all__ = ["fused_imlp_linear_chain", "imlp_chain_bwd_cuda",
           "imlp_chain_bwd_plain", "imlp_chain_fwd_cuda",
           "imlp_chain_fwd_plain", "launches", "reset_launches",
           "corr_lookup_cuda", "corr_lookup_plain"]
