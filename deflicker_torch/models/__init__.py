from .imlp import (IMLPSpec, imlp_apply, imlp_apply_fused, imlp_init,
                   positional_encoding)
from .refine import TransformNet
from .unet import UNet

__all__ = ["IMLPSpec", "imlp_apply", "imlp_apply_fused", "imlp_init",
           "positional_encoding", "UNet", "TransformNet"]
