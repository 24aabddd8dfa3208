"""Tensor ops of the port's plain paths: voxelization, geometry, the action
codec, spatial softmax, attention, rays, samplers, occupancy, compositing
and grid sampling. Exports the JAX package's `ops` names."""
from h100_bench.reference.frozen.ops.action_codec import (
    DiscreteAction, argmax_3d, choose_highest_action, discretize_action,
    one_hot_expert_actions)
from h100_bench.reference.frozen.ops.rays import (
    PositionalEncodingSpec, gen_rays, positional_encoding, unproj_map)
from h100_bench.reference.frozen.ops.geometry import (
    euler_to_quaternion, point_to_voxel_index, voxel_index_to_point)
from h100_bench.reference.frozen.ops.spatial_softmax import spatial_softmax_3d
from h100_bench.reference.frozen.ops.voxelize import VoxelizerSpec, voxelize
from h100_bench.reference.frozen.ops.grid_sample import (
    grid_sample_3d, sample_in_canonical_voxel)
from h100_bench.reference.frozen.ops.sampling import (
    sample_coarse, sample_fine, sample_fine_depth)
from h100_bench.reference.frozen.ops.compositing import composite
from h100_bench.reference.frozen.ops.se3_aug import apply_se3_augmentation

__all__ = [
    "DiscreteAction", "argmax_3d", "choose_highest_action",
    "discretize_action", "one_hot_expert_actions", "euler_to_quaternion",
    "point_to_voxel_index", "voxel_index_to_point", "spatial_softmax_3d",
    "VoxelizerSpec", "voxelize", "PositionalEncodingSpec", "gen_rays",
    "positional_encoding", "unproj_map", "grid_sample_3d",
    "sample_in_canonical_voxel", "sample_coarse", "sample_fine",
    "sample_fine_depth", "composite", "apply_se3_augmentation",
]
