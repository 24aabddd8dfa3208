"""Voxel index <-> metric point conversions (counterpart of the JAX
package's `ops/geometry.py`)."""
from __future__ import annotations

import torch

_EPS = 1e-12


def point_to_voxel_index(point: torch.Tensor, voxel_size: int,
                         coord_bounds: torch.Tensor) -> torch.Tensor:
    """Metric points (..., 3) -> int32 voxel indices (..., 3).

    res = range / voxel_size, floor, then clamp from above only: points
    below the low bound give negative indices, which callers treat as
    invalid (the reference convention).
    """
    bb_min = coord_bounds[..., 0:3]
    bb_max = coord_bounds[..., 3:6]
    res = (bb_max - bb_min) / (voxel_size + _EPS)
    idx = torch.floor((point - bb_min) / (res + _EPS)).to(torch.int32)
    return torch.clamp(idx, max=voxel_size - 1)


def voxel_index_to_point(index: torch.Tensor, voxel_size: int,
                         coord_bounds: torch.Tensor) -> torch.Tensor:
    """Voxel index -> metric voxel-centre coordinate (continuous decode)."""
    bb_min = coord_bounds[..., 0:3]
    bb_max = coord_bounds[..., 3:6]
    res = (bb_max - bb_min) / voxel_size
    return bb_min + res * index.to(torch.float32) + res / 2.0
