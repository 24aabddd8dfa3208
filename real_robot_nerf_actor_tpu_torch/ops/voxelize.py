"""Point cloud -> bounded feature voxel grid (scatter-mean).

Counterpart of the JAX package's `ops/voxelize.py`, with the same layout:
  - a grid of (voxel_size+2)^3 cells; points are binned with a one-voxel
    shift so out-of-bound points land in the border cells, which are
    cropped afterwards;
  - each point scatters [xyz, features..., 1]; the trailing ones column is
    the count, so one scatter gives both sums and counts;
  - invalid (padding) points scatter zeros into cell 0, a border cell;
  - output channels (channel-last): [mean xyz (3), mean feat (F),
    index/voxel_size (3), occupancy (1)].
The scatter is `index_add_` over a flat (B * (V+2)^3) cell space. On CUDA it
adds with atomics, so voxel means may differ in the last bits between runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class VoxelizerSpec:
    voxel_size: int = 100
    feature_size: int = 3
    max_num_coords: int = 220000

    @property
    def out_channels(self) -> int:
        # xyz + features + index coords + occupancy
        return 3 + self.feature_size + 3 + 1


def _index_grid(voxel_size: int, device, dtype=torch.float32) -> torch.Tensor:
    """(V, V, V, 3) normalized voxel index coordinates, index/voxel_size."""
    ar = torch.arange(voxel_size, device=device, dtype=dtype)
    gx, gy, gz = torch.meshgrid(ar, ar, ar, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1) / float(voxel_size)


def pad_points(coords: torch.Tensor, features: torch.Tensor, max_num_coords: int):
    """(B, N, 3) points and (B, N, F) features -> (B, M, 3), (B, M, F) and
    valid (B, M), M = max_num_coords: the first M points, or all N padded
    with invalid zeros (data/replay.pad_point_cloud's rule, on the device)."""
    b, n = coords.shape[:2]
    m = max_num_coords
    valid = (torch.arange(m, device=coords.device) < n).expand(b, m)
    if n >= m:
        return coords[:, :m], features[:, :m], valid
    return (torch.cat([coords, coords.new_zeros((b, m - n, coords.shape[2]))], dim=1),
            torch.cat([features, features.new_zeros((b, m - n, features.shape[2]))], dim=1),
            valid)


def voxelize(coords: torch.Tensor, features: torch.Tensor,
             coord_bounds: torch.Tensor, spec: VoxelizerSpec,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter-mean voxelization.

    coords: (B, N, 3) metric points; features: (B, N, F);
    coord_bounds: (B, 6) or (6,); valid: optional (B, N) bool.
    Returns (B, V, V, V, 7+F) channel-last.
    """
    b, n, _ = coords.shape
    v = spec.voxel_size
    vp = v + 2
    if coord_bounds.dim() == 1:
        coord_bounds = coord_bounds[None].expand(b, 6)
    bb_min = coord_bounds[:, None, 0:3]
    bb_max = coord_bounds[:, None, 3:6]
    span = bb_max - bb_min
    res = span / span.new_full((), float(v) + _EPS)   # see geometry.py
    shifted_min = bb_min - res
    idx = torch.floor((coords - shifted_min) / (res + _EPS)).to(torch.int64)
    idx = torch.clamp(idx, 0, vp - 1)

    if valid is None:
        valid_f = torch.ones((b, n, 1), dtype=coords.dtype, device=coords.device)
    else:
        valid_f = valid[..., None].to(coords.dtype)
        idx = torch.where(valid[..., None], idx, torch.zeros_like(idx))

    flat_idx = (idx[..., 0] * vp + idx[..., 1]) * vp + idx[..., 2]   # (B, N)
    num_segments = vp * vp * vp
    flat_idx = flat_idx + torch.arange(b, device=coords.device)[:, None] * num_segments
    values = torch.cat([coords, features, torch.ones_like(valid_f)], dim=-1)
    values = values * valid_f

    sums = torch.zeros((b * num_segments, values.shape[-1]),
                       dtype=values.dtype, device=values.device)
    sums.index_add_(0, flat_idx.reshape(-1), values.reshape(-1, values.shape[-1]))
    counts = torch.clamp(sums[:, -1:], min=1.0)
    grid = (sums / counts).reshape(b, vp, vp, vp, -1)

    vox = grid[:, 1:-1, 1:-1, 1:-1]
    occupied = (vox[..., -1:] > 0).to(coords.dtype)
    index_coords = _index_grid(v, coords.device, coords.dtype)[None].expand(
        b, v, v, v, 3)
    return torch.cat([vox[..., :-1], index_coords, occupied], dim=-1)
