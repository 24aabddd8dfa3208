"""Bilinear image resize with `jax.image.resize`'s definition (antialias
on), where the 2-D encoder brings its stage maps to the stem's resolution
(the port's `ops/resize.py`, cut to "bilinear").

Each resized axis is one (n_in, n_out) weight matrix: output sample i sits
at s = (i + 0.5) * n_in / n_out - 0.5 in input pixels; input pixel j gets
the triangle k(|s - j| / max(n_in / n_out, 1)), so the kernel widens when
the axis shrinks; each column is normalised to sum 1 (taps past the border
fall away, which clamps at the edges). `F.interpolate(mode="bilinear",
align_corners=False)` computes the same when it enlarges an axis.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float64 weights of one axis (see the module doc)."""
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv_scale, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Resize axes 1 and 2 of NHWC `x` to `size` (an axis already of its
    size is left as it is), in x's dtype."""
    for d, n in zip((1, 2), size):
        if x.shape[d] == n:
            continue
        w = torch.as_tensor(resize_weights(x.shape[d], n), dtype=x.dtype, device=x.device)
        x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x
