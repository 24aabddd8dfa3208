"""Action codec: continuous gripper pose <-> discrete (voxel index, euler
bins, grip, collision), one-hot expert targets, and the argmax decode
(counterpart of the JAX package's `ops/action_codec.py`)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from h100_bench.reference.frozen.ops.geometry import point_to_voxel_index


class DiscreteAction(NamedTuple):
    trans: torch.Tensor       # (B, 3) int32 voxel indices
    rot_grip: torch.Tensor    # (B, 4) int32 [rx_bin, ry_bin, rz_bin, grip]
    collision: torch.Tensor   # (B, 1) int32


def discretize_action(xyz: torch.Tensor, rotation_deg: torch.Tensor,
                      gripper_open: torch.Tensor,
                      ignore_collisions: torch.Tensor,
                      coord_bounds: torch.Tensor, voxel_size: int,
                      rotation_resolution: float = 5.0) -> DiscreteAction:
    """Continuous pose -> discrete action indices.

    bin = int((r + 180) / res) - 1: the int cast truncates toward zero and
    the -1 is the reference's off-by-one bin shift, both kept.
    """
    trans = point_to_voxel_index(xyz, voxel_size, coord_bounds)
    rot_bins = ((rotation_deg + 180.0) / rotation_resolution).to(torch.int32) - 1
    grip = gripper_open.to(torch.int32)
    rot_grip = torch.cat([rot_bins, grip[..., None]], dim=-1)
    coll = ignore_collisions.to(torch.int32)[..., None]
    return DiscreteAction(trans=trans, rot_grip=rot_grip, collision=coll)


def one_hot_expert_actions(action: DiscreteAction, voxel_size: int,
                           num_rotation_classes: int = 72):
    """One-hot int32 targets: trans (B, V^3), rot_x/y/z (B, R), grip (B, 2),
    collision (B, 2)."""
    b = action.trans.shape[0]
    t = action.trans.long()
    flat_idx = (t[:, 0] * voxel_size + t[:, 1]) * voxel_size + t[:, 2]
    trans_oh = torch.zeros((b, voxel_size ** 3), dtype=torch.int32,
                           device=t.device)
    trans_oh[torch.arange(b, device=t.device), flat_idx] = 1

    def one_hot(idx, n):   # rows of eye: an index of -1 wraps, as in JAX
        return torch.eye(n, dtype=torch.int32, device=idx.device)[idx.long()]

    rot_oh = one_hot(action.rot_grip[:, :3], num_rotation_classes)  # (B, 3, R)
    return {
        "trans": trans_oh,
        "rot_x": rot_oh[:, 0],
        "rot_y": rot_oh[:, 1],
        "rot_z": rot_oh[:, 2],
        "grip": one_hot(action.rot_grip[:, 3], 2),
        "collision": one_hot(action.collision[:, 0], 2),
    }


def argmax_3d(q_trans: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W) or (B, D, H, W, 1) -> int32 (B, 3) indices of the max
    (the first one on ties)."""
    if q_trans.dim() == 5:
        q_trans = q_trans[..., 0]
    b, d, h, w = q_trans.shape
    idx = torch.argmax(q_trans.reshape(b, -1), dim=-1)
    return torch.stack([idx // (h * w), (idx // w) % h, idx % w],
                       dim=-1).to(torch.int32)


def choose_highest_action(q_trans, q_rot_grip, q_collision,
                          rotation_resolution: float = 5.0):
    """Argmax decode of all heads -> (coords (B,3), rot_grip (B,4),
    collision (B,1)), all int32."""
    coords = argmax_3d(q_trans)
    r = int(360.0 // rotation_resolution)
    q_rot = q_rot_grip[:, : 3 * r].reshape(-1, 3, r)
    rot_idx = torch.argmax(q_rot, dim=-1)
    grip_idx = torch.argmax(q_rot_grip[:, 3 * r:], dim=-1, keepdim=True)
    rot_grip = torch.cat([rot_idx, grip_idx], dim=-1).to(torch.int32)
    coll = torch.argmax(q_collision[:, -2:], dim=-1,
                        keepdim=True).to(torch.int32)
    return coords, rot_grip, coll
