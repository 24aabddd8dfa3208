"""Translation-only SE(3) augmentation of keyframe BC samples (counterpart
of the JAX package's `ops/se3_aug.py`).

A bounded random shift of the point cloud and of its keyframe actions,
clamped so that every shifted keyframe stays inside the bounds, with no
retry loop: the same support as the reference's rejection sampling. The
shift's uniform draw `u` in [-1, 1)^3 is an argument, so a caller can feed
the JAX package's draws; without it, it comes from `generator`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from h100_bench.reference.frozen.ops.geometry import point_to_voxel_index


class Se3AugOut(NamedTuple):
    pcd: torch.Tensor           # (..., N, 3) shifted point cloud
    action_trans: torch.Tensor  # (..., K, 3) int32 voxel indices of the shifted keyframes
    shift: torch.Tensor         # (..., 3) the applied metric shift


def apply_se3_augmentation(pcd: torch.Tensor, keyframe_xyz: torch.Tensor,
                           coord_bounds: torch.Tensor,
                           trans_aug_range: torch.Tensor, voxel_size: int,
                           symmetric_clamp: bool = True,
                           u: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> Se3AugOut:
    """Shared bounded translation of a point cloud and K keyframe actions.

    pcd (B, N, 3) with keyframe_xyz (K, 3) and u (3,) shifts all B clouds
    by one shift, as the JAX function does; keyframe_xyz (B, K, 3) with u
    (B, 3) gives each cloud its own (the JAX function under vmap).
    coord_bounds (6,); trans_aug_range (3,), fractions of the scene extent.

    symmetric_clamp=True clamps the shift to the largest symmetric
    feasible window [-m, m], m = min(range, hi, -lo), so its marginal stays
    zero-mean for every keyframe; False clamps it to [lo, hi], the
    reference's truncated support with a boundary atom.
    """
    bb_min = coord_bounds[0:3]
    bb_max = coord_bounds[3:6]
    trans_range = (bb_max - bb_min) * trans_aug_range
    if u is None:
        gen_dev = generator.device if generator is not None else "cpu"
        u = torch.rand(keyframe_xyz.shape[:-2] + (3,), generator=generator,
                       device=gen_dev, dtype=pcd.dtype) * 2.0 - 1.0
    shift = trans_range * u.to(pcd.device, pcd.dtype)

    # every shifted keyframe in bounds:
    # shift in [max_k(bb_min - xyz_k), min_k(bb_max - xyz_k)]
    eps = (bb_max - bb_min) * 1e-6
    lo = torch.amax(bb_min - keyframe_xyz, dim=-2)
    hi = torch.amin(bb_max - keyframe_xyz, dim=-2) - eps
    if symmetric_clamp:
        m = torch.clamp(torch.minimum(hi, -lo), min=0.0)
        lo, hi = -m, m
    shift = torch.minimum(torch.maximum(shift, lo), hi)

    perturbed_xyz = keyframe_xyz + shift[..., None, :]
    action_trans = point_to_voxel_index(perturbed_xyz, voxel_size, coord_bounds)
    return Se3AugOut(pcd=pcd + shift[..., None, :], action_trans=action_trans,
                     shift=shift)
