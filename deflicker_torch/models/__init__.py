from .gma import GMA, gma_init
from .imlp import (IMLPSpec, imlp_apply, imlp_apply_fused, imlp_init,
                   positional_encoding)
from .raft import RAFT, build_corr_pyramid, corr_lookup, raft_flow, raft_init
from .refine import TransformNet, transformnet_init
from .unet import UNet, unet_init

__all__ = ["IMLPSpec", "imlp_apply", "imlp_apply_fused", "imlp_init",
           "positional_encoding", "UNet", "TransformNet", "unet_init",
           "transformnet_init", "RAFT", "raft_flow", "raft_init",
           "RAFTModules", "build_corr_pyramid", "corr_lookup", "GMA",
           "gma_init"]

RAFTModules = RAFT       # the JAX package's name for the RAFT modules
