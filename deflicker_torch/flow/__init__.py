from ..utils.convert import raft_variables_from_state_dict
from .convert import load_raft_checkpoint
from .engine import (FarnebackFlow, RAFTFlow, load_flow_image,
                     preprocess_optical_flow)

# the JAX package's name: a RAFT `.pth` state dict as the flax variables
convert_raft_state_dict = raft_variables_from_state_dict

__all__ = ["FarnebackFlow", "RAFTFlow", "load_flow_image",
           "load_raft_checkpoint", "preprocess_optical_flow",
           "convert_raft_state_dict"]
