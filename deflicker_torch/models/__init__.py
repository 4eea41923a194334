from .imlp import (IMLPSpec, imlp_apply, imlp_apply_fused, imlp_init,
                   positional_encoding)
from .raft import RAFT, raft_flow, raft_init
from .refine import TransformNet
from .unet import UNet

__all__ = ["IMLPSpec", "imlp_apply", "imlp_apply_fused", "imlp_init",
           "positional_encoding", "UNet", "TransformNet", "RAFT", "raft_flow",
           "raft_init"]
