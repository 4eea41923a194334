from .ewarp import occlusion_mask, warp_error, warp_error_video
from .psnr import psnr

__all__ = ["psnr", "warp_error", "warp_error_video", "occlusion_mask"]
