from .checkpoint import load_checkpoint, save_checkpoint, to_host
from .debug import (assert_all_finite, enable_numerics_debug,
                    numerics_debug_enabled)
from .device import resolve_device
from .logging import ScalarLogger

__all__ = ["save_checkpoint", "load_checkpoint", "to_host", "ScalarLogger",
           "resolve_device", "assert_all_finite", "enable_numerics_debug",
           "numerics_debug_enabled"]
