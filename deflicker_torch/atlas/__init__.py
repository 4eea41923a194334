from .data import VideoData, load_video_data
from .engine import (AtlasSpecs, FitResult, build_specs, fit_atlas,
                     init_models, make_loss_fn, pretrain_mapping,
                     select_imlp_apply)
from .render import evaluate_and_save, render_frames, save_mask_flow_videos

__all__ = ["VideoData", "load_video_data", "AtlasSpecs", "FitResult",
           "build_specs", "fit_atlas", "init_models", "make_loss_fn",
           "pretrain_mapping", "select_imlp_apply", "evaluate_and_save",
           "render_frames", "save_mask_flow_videos"]
