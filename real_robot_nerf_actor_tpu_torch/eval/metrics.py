"""Image quality metrics, numpy (the port's copy of `mse_np` and `psnr_np`
from the JAX package's `eval/metrics.py`)."""
from __future__ import annotations

import numpy as np


def mse_np(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def psnr_np(img: np.ndarray, gt: np.ndarray, max_val: float = 1.0) -> float:
    m = mse_np(img, gt)
    if m == 0:
        return 100.0
    return float(20.0 * np.log10(max_val / np.sqrt(m)))
