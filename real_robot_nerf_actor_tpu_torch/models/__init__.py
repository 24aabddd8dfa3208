"""The voxel policy (PerceiverIO and its blocks), the NeRF field, and CLIP's
tokenizer and text tower (`clip_bpe`, `clip_text`)."""
from real_robot_nerf_actor_tpu_torch.models.nerf_field import (
    NerfFieldConfig, VoxelNerfField)
from real_robot_nerf_actor_tpu_torch.models.perceiver import (
    PerceiverConfig, PerceiverIO)
from real_robot_nerf_actor_tpu_torch.models.resnetfc import ResnetFC

__all__ = ["NerfFieldConfig", "PerceiverConfig", "PerceiverIO", "ResnetFC",
           "VoxelNerfField"]
