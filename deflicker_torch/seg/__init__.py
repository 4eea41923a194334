from .providers import (CarvekitMasks, GrabCutMasks, MaskRCNNMasks,
                        PrecomputedMasks, get_mask_provider, preprocess_masks,
                        select_instance_mask)

__all__ = [
    "CarvekitMasks", "GrabCutMasks", "MaskRCNNMasks", "PrecomputedMasks",
    "get_mask_provider", "preprocess_masks", "select_instance_mask",
]
