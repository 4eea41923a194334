"""Warm serving API: load the networks once, deflicker many videos on one
card.

    from deflicker_torch import Deflickerer

    d = Deflickerer()                       # cuda:0; weights load at first use
    out_a = d.process("a.mp4")              # first call builds the kernels
    out_b = d.process("b.mp4")              # weights and kernels reused

What stays warm across jobs: the RAFT and stage-2 weights, on the device
once (`flow_provider`, `filter_engine`, each made at its first use); the two
CUDA libraries, built and loaded once a process (`ops/cuda/build.load`);
the stage-1 fit's CUDA graphs (`fit_graphs`, atlas/graphs.py: the
pretrains' and each loss phase's fit step, kept by the fit's shape, so a
later job of a shape already seen copies its pack and init params in and
captures nothing); the RAFT solves' and the refinement steps' CUDA graphs
(`flow_provider.graphs`, `filter_engine.graphs`, kept by shape in each
engine's one memory pool: a later job of a shape already solved or
refined copies its frames into the static buffers and captures nothing);
and the frames and flow of a clip already under `<root>/<stem>/`, which
are neither decoded nor solved again.  Each `graphs.captured` counts its
captures, and dropping the `Deflickerer` frees every pool.

`mesh="auto"` (the default) picks up an initialised `torch.distributed`
world of several ranks (`torchrun`, parallel/mesh.py): every rank then
builds its `Deflickerer` and calls `process` with the same arguments, the
work splits over the ranks' cards, and rank 0 writes.  Otherwise, or with
`mesh=None`, `device` names the one card.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional

from .config import AtlasConfig, PipelineConfig, load_atlas_config
from .utils.device import resolve_device


class Deflickerer:
    """Reusable deflickering service handle (see module docstring).
    `device=None` means `cuda:0` and raises without a CUDA device; the tests
    pass "cpu"."""

    def __init__(self,
                 ckpt_raft: str = "./pretrained_weights/raft-things.pth",
                 ckpt_filter: str = "./pretrained_weights/neural_filter.pth",
                 ckpt_local: str =
                 "./pretrained_weights/local_refinement_net.pth",
                 config: str = "config_flow_100.json",
                 root: str = "data/test/",
                 results_root: str = "results",
                 stage2_dtype: str = "bfloat16",
                 stage2_unpad: str = "crop",
                 device=None, mesh: object = "auto"):
        if mesh == "auto":
            import torch.distributed as dist

            mesh = None
            if dist.is_initialized() and dist.get_world_size() > 1:
                from .parallel import make_mesh

                mesh = make_mesh()
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
        self.device = resolve_device("cuda:0" if device is None else device)
        self.ckpt_raft = ckpt_raft
        self.ckpt_filter = ckpt_filter
        self.ckpt_local = ckpt_local
        self.root = root
        self.results_root = results_root
        self.stage2_dtype = stage2_dtype
        self.stage2_unpad = stage2_unpad
        cfg_path = Path(config)
        self.atlas_cfg = (load_atlas_config(cfg_path) if cfg_path.exists()
                          else AtlasConfig())
        self._flow_provider = None
        self._filter_engine = None
        from .atlas.graphs import FitGraphs

        self.fit_graphs = FitGraphs(keep=True)

    # -- lazy, load-once network state -------------------------------------
    @property
    def flow_provider(self):
        if self._flow_provider is None:
            from .cli.pipeline import make_flow_provider

            self._flow_provider = make_flow_provider(
                self._pipe_cfg(video_name="_"), self.device, self.mesh)
        return self._flow_provider

    @property
    def filter_engine(self):
        if self._filter_engine is None:
            import torch

            from .filter import load_filter_engine

            self._filter_engine = load_filter_engine(
                self.ckpt_filter, self.ckpt_local, device=self.device,
                dtype=getattr(torch, self.stage2_dtype),
                unpad=self.stage2_unpad, mesh=self.mesh)
        return self._filter_engine

    def _pipe_cfg(self, **overrides) -> PipelineConfig:
        base = dict(ckpt_raft=self.ckpt_raft, ckpt_filter=self.ckpt_filter,
                    ckpt_local=self.ckpt_local, root=self.root,
                    results_root=self.results_root,
                    stage2_dtype=self.stage2_dtype,
                    stage2_unpad=self.stage2_unpad)
        base.update(overrides)
        return PipelineConfig(**base)

    def process(self, video: Optional[str] = None,
                frame_folder: Optional[str] = None,
                class_name: Optional[str] = None,
                down: Optional[int] = None,
                fps: int = 10,
                iters: Optional[int] = None,
                seed: Optional[int] = None) -> Dict:
        """Run the full pipeline on one video; returns the metrics dict
        (same contract as cli.pipeline.run_pipeline).  Weights and kernels
        persist across calls."""
        from .cli.pipeline import run_pipeline

        cfg = self._pipe_cfg(video_name=video,
                             video_frame_folder=frame_folder,
                             class_name=class_name, down=down, fps=fps)
        atlas_cfg = self.atlas_cfg
        overrides = {}
        if iters is not None:
            overrides = {"iters_num": iters,
                         "evaluate_every": max(1, iters - 1)}
        if seed is not None:
            overrides["seed"] = seed
        if overrides:
            atlas_cfg = dataclasses.replace(atlas_cfg, **overrides)
        return run_pipeline(cfg, atlas_cfg, device=self.device,
                            flow_provider=self.flow_provider,
                            filter_engine=self.filter_engine, mesh=self.mesh,
                            graphs=self.fit_graphs)
