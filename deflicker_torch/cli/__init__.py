"""Command-line entry points of the port."""

from .main import build_parser, main
from .pipeline import run_pipeline, run_stage1, run_stage2

__all__ = ["build_parser", "main", "run_pipeline", "run_stage1", "run_stage2"]
