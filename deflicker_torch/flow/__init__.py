from .convert import load_raft_checkpoint
from .engine import (FarnebackFlow, RAFTFlow, load_flow_image,
                     preprocess_optical_flow)

__all__ = ["FarnebackFlow", "RAFTFlow", "load_flow_image",
           "load_raft_checkpoint", "preprocess_optical_flow"]
