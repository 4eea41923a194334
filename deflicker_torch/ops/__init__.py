from .consistency import compute_consistency, consistency_masks, resize_flow
from .convex_upsample import (convex_upsample_flow,
                              resize_bilinear_align_corners, upflow8)
from .coords import coords_grid, normalize_xyt
from .pad import Padder
from .sampling import bilinear_sample, flow_warp

__all__ = ["bilinear_sample", "flow_warp", "coords_grid", "normalize_xyt",
           "compute_consistency", "consistency_masks", "resize_flow",
           "Padder", "resize_bilinear_align_corners", "convex_upsample_flow",
           "upflow8"]
