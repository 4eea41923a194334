from .engine import FarnebackFlow, load_flow_image, preprocess_optical_flow

__all__ = ["FarnebackFlow", "load_flow_image", "preprocess_optical_flow"]
