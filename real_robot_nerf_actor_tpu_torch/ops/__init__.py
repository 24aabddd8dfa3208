"""Tensor ops of the port: voxelization, geometry, the action codec,
spatial softmax, rays, samplers, occupancy, compositing, grid sampling, and
the wrappers of the hand-written Hopper kernels (`attention_cuda`,
`conv3d_cuda`, `stats_cuda`, `lerp_cuda`, `ray_expand_cuda`,
`resnetfc_cuda`). Exports the JAX package's `ops` names."""
from real_robot_nerf_actor_tpu_torch.ops.action_codec import (
    DiscreteAction, argmax_3d, choose_highest_action, discretize_action,
    one_hot_expert_actions)
from real_robot_nerf_actor_tpu_torch.ops.rays import (
    PositionalEncodingSpec, gen_rays, positional_encoding, unproj_map)
from real_robot_nerf_actor_tpu_torch.ops.geometry import (
    euler_to_quaternion, point_to_voxel_index, voxel_index_to_point)
from real_robot_nerf_actor_tpu_torch.ops.spatial_softmax import spatial_softmax_3d
from real_robot_nerf_actor_tpu_torch.ops.voxelize import VoxelizerSpec, voxelize
from real_robot_nerf_actor_tpu_torch.ops.grid_sample import (
    grid_sample_3d, sample_in_canonical_voxel)
from real_robot_nerf_actor_tpu_torch.ops.sampling import (
    sample_coarse, sample_fine, sample_fine_depth)
from real_robot_nerf_actor_tpu_torch.ops.compositing import composite
from real_robot_nerf_actor_tpu_torch.ops.se3_aug import apply_se3_augmentation

__all__ = [
    "DiscreteAction", "argmax_3d", "choose_highest_action",
    "discretize_action", "one_hot_expert_actions", "euler_to_quaternion",
    "point_to_voxel_index", "voxel_index_to_point", "spatial_softmax_3d",
    "VoxelizerSpec", "voxelize", "PositionalEncodingSpec", "gen_rays",
    "positional_encoding", "unproj_map", "grid_sample_3d",
    "sample_in_canonical_voxel", "sample_coarse", "sample_fine",
    "sample_fine_depth", "composite", "apply_se3_augmentation",
]
