from ..utils.convert import load_stage2_module
from .convert import variables_from_state_dict
from .engine import (FilterEngine, filter_frames, load_filter_engine,
                     refine_sequence, refine_sequence_multi, refine_span)

# the JAX package's names: a `.pth` state dict as the flax variable tree,
# and stage-2 weights (`.pth` or `.ckpt`) loaded into a module
convert_conv_state_dict = variables_from_state_dict
load_stage2_checkpoint = load_stage2_module

__all__ = ["FilterEngine", "filter_frames", "load_filter_engine",
           "refine_sequence", "refine_sequence_multi", "refine_span",
           "convert_conv_state_dict", "load_stage2_checkpoint"]
