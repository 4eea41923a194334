from .config import AtlasConfig, PipelineConfig, load_atlas_config

__all__ = ["AtlasConfig", "PipelineConfig", "load_atlas_config"]
