"""Configuration for the deflicker pipeline.

The JSON key set mirrors the reference's stage-1 hyperparameter file
(`src/config/config_flow_100.json:1-46`) so existing configs
drop in unchanged.  Everything is a frozen dataclass, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AtlasConfig:
    """Stage-1 (neural layered atlas) hyperparameters.

    Field names match the reference JSON keys one-to-one
    (reference: src/config/config_flow_100.json).
    """

    results_folder_name: str = "results"
    maximum_number_of_frames: int = 200
    # NOTE: like the reference, resx/resy in the JSON are ignored by the
    # pipeline — the working resolution is first-frame-resolution / down
    # (reference: src/stage1_neural_atlas.py:31-38).
    resx: int = 768
    resy: int = 432
    iters_num: int = 10001
    samples_batch: int = 10000
    optical_flow_coeff: float = 500.0
    evaluate_every: int = 10000
    derivative_amount: int = 1
    rgb_coeff: float = 5000.0
    rigidity_coeff: float = 1.0
    uv_mapping_scale: float = 0.8
    pretrain_mapping1: bool = True
    pretrain_mapping2: bool = True
    alpha_bootstrapping_factor: float = 2000.0
    alpha_flow_factor: float = 4900.0
    positional_encoding_num_alpha: int = 5
    number_of_channels_atlas: int = 256
    number_of_layers_atlas: int = 8
    number_of_channels_alpha: int = 256
    number_of_layers_alpha: int = 8
    stop_bootstrapping_iteration: int = 10000
    number_of_channels_mapping1: int = 256
    number_of_layers_mapping1: int = 6
    number_of_channels_mapping2: int = 256
    number_of_layers_mapping2: int = 4
    gradient_loss_coeff: float = 1000.0
    use_gradient_loss: bool = True
    sparsity_coeff: float = 1000.0
    positional_encoding_num_atlas: int = 10
    use_positional_encoding_mapping1: bool = False
    number_of_positional_encoding_mapping1: int = 4
    use_positional_encoding_mapping2: bool = False
    number_of_positional_encoding_mapping2: int = 2
    pretrain_iter_number: int = 100
    load_checkpoint: bool = False
    checkpoint_path: str = ""
    include_global_rigidity_loss: bool = True
    global_rigidity_derivative_amount_fg: int = 100
    global_rigidity_derivative_amount_bg: int = 100
    global_rigidity_coeff_fg: float = 5.0
    global_rigidity_coeff_bg: float = 50.0
    stop_global_rigidity: int = 5000
    add_to_experiment_folder_name: str = ""

    # --- framework extensions (not in the reference JSON) ---
    # Adam learning rate (reference hard-codes 1e-4,
    # src/stage1_neural_atlas.py:132-134).
    learning_rate: float = 1e-4
    # Optimizer steps per logging chunk: the per-chunk mean of each loss
    # term is read back once per chunk (one host sync per chunk).
    steps_per_call: int = 250
    # RNG seed for the fit (the reference stage-1 is unseeded; we define
    # seeded behavior for reproducibility).
    seed: int = 0
    # Matmul precision for the fit MLPs: "highest" = full fp32 (reference
    # numerics), "default" = bf16 multiply + fp32 accumulate (params and
    # optimizer stay fp32).
    fit_precision: str = "default"
    # Use the fused IMLP chain kernel (ops/cuda, csrc/imlp_chain.cu) for the
    # bf16 fit path; fit_precision="highest" always takes the plain fp32
    # path.  The name is kept so reference JSONs written for the JAX
    # package load unchanged.
    use_pallas_imlp: bool = True
    # Write residual/uv/per-pixel-loss diagnostic mp4s at evaluation (and
    # the alpha / uv_2 set on the dual path); off by default: it renders
    # every frame a second time and draws a matplotlib panel per frame.
    save_diagnostics: bool = False

    def to_reference_json(self) -> dict:
        """Dump only the reference-compatible key set."""
        ref_keys = {
            "results_folder_name", "maximum_number_of_frames", "resx", "resy",
            "iters_num", "samples_batch", "optical_flow_coeff", "evaluate_every",
            "derivative_amount", "rgb_coeff", "rigidity_coeff", "uv_mapping_scale",
            "pretrain_mapping1", "pretrain_mapping2", "alpha_bootstrapping_factor",
            "alpha_flow_factor", "positional_encoding_num_alpha",
            "number_of_channels_atlas", "number_of_layers_atlas",
            "number_of_channels_alpha", "number_of_layers_alpha",
            "stop_bootstrapping_iteration", "number_of_channels_mapping1",
            "number_of_layers_mapping1", "number_of_channels_mapping2",
            "number_of_layers_mapping2", "gradient_loss_coeff", "use_gradient_loss",
            "sparsity_coeff", "positional_encoding_num_atlas",
            "use_positional_encoding_mapping1",
            "number_of_positional_encoding_mapping1",
            "use_positional_encoding_mapping2",
            "number_of_positional_encoding_mapping2", "pretrain_iter_number",
            "load_checkpoint", "checkpoint_path", "include_global_rigidity_loss",
            "global_rigidity_derivative_amount_fg",
            "global_rigidity_derivative_amount_bg", "global_rigidity_coeff_fg",
            "global_rigidity_coeff_bg", "stop_global_rigidity",
            "add_to_experiment_folder_name",
        }
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if k in ref_keys}


def load_atlas_config(path: str | Path) -> AtlasConfig:
    """Load an AtlasConfig from a reference-format JSON file.

    Unknown keys are ignored; missing keys keep their defaults, matching the
    reference's dict-lookup behavior.
    """
    with open(path) as f:
        raw = json.load(f)
    field_names = {f.name for f in dataclasses.fields(AtlasConfig)}
    return AtlasConfig(**{k: v for k, v in raw.items() if k in field_names})


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline options (mirrors test.py's public CLI flags,
    reference: test.py:4-11, plus stage-internal flags)."""

    video_name: Optional[str] = None           # path to input .mp4
    video_frame_folder: Optional[str] = None   # or a folder of frames
    fps: int = 10
    class_name: Optional[str] = None           # segmentation class; None = single atlas
    gpu: int = 0                               # CUDA device index (--gpu N -> cuda:N)
    ckpt_filter: str = "./pretrained_weights/neural_filter.pth"
    ckpt_local: str = "./pretrained_weights/local_refinement_net.pth"
    ckpt_raft: str = "./pretrained_weights/raft-things.pth"

    # stage-1 args (reference: src/stage1_neural_atlas.py:259-264).
    # down=None means "auto": 4 on the single-atlas path, 1 on the seg path
    # (the reference scripts' respective --down defaults).
    config: str = "config_flow_100.json"
    down: Optional[int] = None
    root: str = "data/test/"
    results_root: str = "results"

    # flow preprocessing (reference: src/preprocess_optical_flow.py:37-42)
    max_long_edge: int = 2000

    # segmentation provider for the dual-atlas path: "carvekit", "maskrcnn",
    # or "grabcut" (dependency-free).  None = reference behavior
    # (carvekit for class_name == "portrait", Mask-RCNN otherwise).
    mask_provider: Optional[str] = None

    # framework extensions
    # stage-2 conv compute dtype: "bfloat16" casts weights and input to bf16
    # and the output back to f32; "float32" for reference numerics.
    stage2_dtype: str = "bfloat16"
    # stage-2 padded->original unpadding: "crop" (exact; default) or
    # "resize" (the reference's unpad-by-resize quirk, which vertically
    # squashes non-/32 frames by the padding amount — costs ~10 dB of
    # final fidelity on a 90-row video)
    stage2_unpad: str = "crop"
