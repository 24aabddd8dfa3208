"""Tensor ops of the port: voxelization, geometry, the action codec,
spatial softmax, rays, samplers, occupancy, compositing, grid sampling, and
the wrappers of the hand-written Hopper kernels (`attention_cuda`,
`conv3d_cuda`, `stats_cuda`, `lerp_cuda`, `ray_expand_cuda`,
`resnetfc_cuda`)."""
from real_robot_nerf_actor_tpu_torch.ops.action_codec import (
    DiscreteAction, argmax_3d, choose_highest_action, discretize_action)
from real_robot_nerf_actor_tpu_torch.ops.rays import (
    PositionalEncodingSpec, gen_rays, positional_encoding, unproj_map)
from real_robot_nerf_actor_tpu_torch.ops.geometry import (
    point_to_voxel_index, voxel_index_to_point)
from real_robot_nerf_actor_tpu_torch.ops.spatial_softmax import spatial_softmax_3d
from real_robot_nerf_actor_tpu_torch.ops.voxelize import VoxelizerSpec, voxelize

__all__ = [
    "DiscreteAction", "argmax_3d", "choose_highest_action",
    "discretize_action", "point_to_voxel_index", "voxel_index_to_point",
    "spatial_softmax_3d", "VoxelizerSpec", "voxelize", "PositionalEncodingSpec",
    "gen_rays", "positional_encoding", "unproj_map",
]
