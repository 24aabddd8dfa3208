"""Image resize with `jax.image.resize`'s definition ("bilinear" and
"bicubic", antialias on), used where the JAX package resizes: the 2-D
encoder's stage upsample, the student's prediction map and the ViT's
positional grid.

Each resized axis is one (n_in, n_out) weight matrix: output sample i sits
at s = (i + 0.5) * n_in / n_out - 0.5 in input pixels; input pixel j gets
k(|s - j| / max(n_in / n_out, 1)) with k the triangle (bilinear) or Keys'
cubic with a = -0.5 (bicubic), so the kernel widens to low-pass filter when
the axis shrinks; each column is normalised to sum 1 (taps past the border
fall away, which clamps at the edges). `F.interpolate` differs from this
when it shrinks an axis (no antialias by default) and in its bicubic
(a = -0.75, taps clamped to the border instead of dropped).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def resize_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_in, n_out) float64 weights of one axis (see the module doc)."""
    kernel = _KERNELS[method]
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv_scale, 1.0)
    w = kernel(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize(x: torch.Tensor, size: Sequence[int], method: str = "bilinear",
           dims: Sequence[int] = (1, 2)) -> torch.Tensor:
    """Resize axes `dims` of `x` to `size` (axes already of their size are
    left as they are), in x's dtype."""
    for d, n in zip(dims, size):
        if x.shape[d] == n:
            continue
        w = torch.as_tensor(resize_weights(x.shape[d], n, method), dtype=x.dtype,
                            device=x.device)
        x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x
