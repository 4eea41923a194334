"""Peak signal-to-noise ratio (scikit-image-compatible)."""

from __future__ import annotations

import numpy as np


def psnr(reference: np.ndarray, test: np.ndarray, data_range: float = 1.0) -> float:
    """PSNR = 10*log10(data_range^2 / MSE), matching
    `skimage.metrics.peak_signal_noise_ratio` as used by the reference
    evaluator (src/models/stage_1/evaluate.py:740-743)."""
    reference = np.asarray(reference, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    mse = np.mean((reference - test) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range ** 2) / mse))
