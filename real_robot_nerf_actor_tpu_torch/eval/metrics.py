"""Image quality metrics, numpy (the port's copy of `mse_np`, `psnr_np` and
`ssim_np` from the JAX package's `eval/metrics.py`)."""
from __future__ import annotations

import numpy as np


def mse_np(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def psnr_np(img: np.ndarray, gt: np.ndarray, max_val: float = 1.0) -> float:
    m = mse_np(img, gt)
    if m == 0:
        return 100.0
    return float(20.0 * np.log10(max_val / np.sqrt(m)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim_np(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Single-scale SSIM with an 11x11 gaussian window (sigma 1.5, valid
    region only), channels averaged."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    w = _gaussian_window()
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2

    def filt(img):
        out = np.apply_along_axis(lambda r: np.convolve(r, w, mode="valid"), 0, img)
        return np.apply_along_axis(lambda r: np.convolve(r, w, mode="valid"), 1, out)

    mu_a, mu_b = filt(a), filt(b)
    sa = filt(a * a) - mu_a ** 2
    sb = filt(b * b) - mu_b ** 2
    sab = filt(a * b) - mu_a * mu_b
    ssim_map = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (sa + sb + c2))
    return float(ssim_map.mean())
