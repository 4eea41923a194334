from .engine import (FilterEngine, filter_frames, load_filter_engine,
                     refine_sequence, refine_span)

__all__ = ["FilterEngine", "filter_frames", "load_filter_engine",
           "refine_sequence", "refine_span"]
