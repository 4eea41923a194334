"""Stage-2 training on procedural clips (the JAX package's
`deflicker_tpu.train`): `synth` makes the clips on the device,
`stage2_trainer` trains the UNet filter and the TransformNet refiner."""

from .stage2_trainer import (TrainConfig, train_filter, train_refiner,
                             train_stage2)
from .synth import Clip, make_clip, warp_valid_mask

__all__ = ["TrainConfig", "train_filter", "train_refiner", "train_stage2",
           "Clip", "make_clip", "warp_valid_mask"]
