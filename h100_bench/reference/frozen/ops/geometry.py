"""Voxel index <-> metric point conversions, euler angles -> quaternions and
rigid transforms of points (counterpart of the JAX package's
`ops/geometry.py`)."""
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
    span = bb_max - bb_min
    # the divisor lies on the points' device: CUDA divides by a host scalar
    # as a product with its fp32 reciprocal, one ulp from the quotient at
    # times, which moves a floor (and a CE label) by one voxel
    res = span / span.new_full((), voxel_size + _EPS)
    idx = torch.floor((point - bb_min) / (res + _EPS)).to(torch.int32)
    return torch.clamp(idx, max=voxel_size - 1)


def voxel_index_to_point(index: torch.Tensor, voxel_size: int,
                         coord_bounds: torch.Tensor) -> torch.Tensor:
    """Voxel index -> metric voxel-centre coordinate (continuous decode)."""
    bb_min = coord_bounds[..., 0:3]
    bb_max = coord_bounds[..., 3:6]
    res = (bb_max - bb_min) / voxel_size
    return bb_min + res * index.to(torch.float32) + res / 2.0


def euler_to_quaternion(rpy: torch.Tensor) -> torch.Tensor:
    """Euler (roll, pitch, yaw) radians (..., 3) -> quaternion (qx, qy, qz,
    qw) (..., 4)."""
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    qx = sr * cp * cy - cr * sp * sy
    qy = cr * sp * cy + sr * cp * sy
    qz = cr * cp * sy - sr * sp * cy
    qw = cr * cp * cy + sr * sp * sy
    return torch.stack([qx, qy, qz, qw], dim=-1)


def transform_points(points: torch.Tensor, mat4: torch.Tensor) -> torch.Tensor:
    """Apply a homogeneous 4x4 (or (..., 4, 4)) transform to (..., N, 3)
    points: points @ R^T + t."""
    rot = mat4[..., :3, :3]
    t = mat4[..., :3, 3]
    return points @ rot.transpose(-1, -2) + t[..., None, :]
