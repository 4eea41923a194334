from .data import VideoData, load_video_data
from .engine import (AtlasSpecs, FitResult, build_specs, fit_atlas,
                     init_models, make_loss_fn, pretrain_mapping,
                     select_imlp_apply)
from .multifit import (fit_atlas_multi, group_by_shape, init_models_multi,
                       pretrain_mapping_multi, stack_video_data)
from .render import (evaluate_and_save, render_diagnostics, render_frame,
                     render_frames, save_diagnostic_videos,
                     save_mask_flow_videos)
from .texture import (export_atlas_artifacts, get_high_res_texture,
                      get_mapping_area, render_from_texture)

__all__ = ["VideoData", "load_video_data", "AtlasSpecs", "FitResult",
           "build_specs", "fit_atlas", "init_models", "make_loss_fn",
           "pretrain_mapping", "select_imlp_apply", "evaluate_and_save",
           "render_diagnostics", "render_frame", "render_frames",
           "save_diagnostic_videos", "save_mask_flow_videos",
           "export_atlas_artifacts", "get_high_res_texture",
           "get_mapping_area", "render_from_texture", "fit_atlas_multi",
           "group_by_shape", "init_models_multi", "pretrain_mapping_multi",
           "stack_video_data"]
