"""The reference's public entry points with its signatures (counterpart of
the JAX package's `compat.py`): `VoxelGrid.coords_to_bounding_voxel_grid`,
`gen_rays` and `choose_highest_action`, over the port's `ops.voxelize`,
`ops.rays.gen_rays` and `ops.action_codec.choose_highest_action`, so that
a user of the reference can switch with few edits. New code should call
those functions directly.
"""
from __future__ import annotations

import numpy as np
import torch

from real_robot_nerf_actor_tpu_torch.ops.action_codec import (
    choose_highest_action as _choose)
from real_robot_nerf_actor_tpu_torch.ops.rays import gen_rays as _gen_rays
from real_robot_nerf_actor_tpu_torch.ops.voxelize import VoxelizerSpec, pad_points, voxelize
from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device


def _tensor(x, device, dtype=torch.float32):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _device_of(*xs) -> torch.device:
    """The device of the first tensor among xs; with none, the card (raises
    where there is none): pass CPU tensors to run on the CPU."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device("cuda")


class VoxelGrid:
    """Signature-compatible with the reference voxelizer
    (voxel_grid_real.py:15-233). `device` names where the grid is built
    (CUDA raises where there is none); `batch_size` is kept for the
    signature."""

    def __init__(self, coord_bounds, voxel_size: int, device="cuda",
                 batch_size: int = 1, feature_size: int = 3,
                 max_num_coords: int = 220000):
        self.device = resolve_device(device)
        self._bounds = _tensor(coord_bounds, self.device)
        self._spec = VoxelizerSpec(voxel_size=voxel_size, feature_size=feature_size,
                                   max_num_coords=max_num_coords)

    def coords_to_bounding_voxel_grid(self, coords, coord_features=None,
                                      coord_bounds=None, only_features=False):
        """coords (B, N, 3), coord_features (B, N, F) -> channel-LAST
        (B, V, V, V, 7+F) tensor on the grid's device (the reference returns
        this layout before its caller permutes it to channel-first). The
        cloud is padded with invalid points, or truncated, to
        `max_num_coords`; a 2-D `coord_bounds` takes its first row;
        `only_features` drops the last 7 channels."""
        coords = _tensor(coords, self.device)
        if coord_features is None:
            coord_features = torch.zeros_like(coords)
        else:
            coord_features = _tensor(coord_features, self.device)
        bounds = self._bounds if coord_bounds is None else _tensor(coord_bounds, self.device)
        if bounds.dim() > 1:
            bounds = bounds[0]
        coords, coord_features, valid = pad_points(coords, coord_features,
                                                   self._spec.max_num_coords)
        vox = voxelize(coords, coord_features, bounds, self._spec, valid=valid)
        if only_features:
            return vox[..., :-7]
        return vox


def gen_rays(poses, width, height, focal, z_near, z_far, c=None):
    """utils.gen_rays of the reference (utils.py:477-507): (B, 4, 4)
    camera-to-world poses -> (B, H, W, 8) rays, on the poses' device (a
    tensor's, else the card)."""
    device = _device_of(poses)
    return _gen_rays(_tensor(poses, device), width, height, _tensor(focal, device),
                     z_near, z_far, c=c)


def choose_highest_action(q_trans, q_rot_grip, q_collision,
                          rotation_resolution=5.0):
    """The reference's argmax decode (train_peract_...py:712-726); takes
    the channel-first (B, 1, V, V, V) q_trans too. Arrays go to the device
    of the first tensor among the three, or to the card."""
    device = _device_of(q_trans, q_rot_grip, q_collision)
    q_trans, q_rot_grip, q_collision = (
        x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device)
        for x in (q_trans, q_rot_grip, q_collision))
    if q_trans.dim() == 5 and q_trans.shape[1] == 1:
        q_trans = q_trans[:, 0]
    return _choose(q_trans, q_rot_grip, q_collision, rotation_resolution)
