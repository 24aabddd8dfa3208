"""The voxel policy (PerceiverIO and its blocks), the NeRF field, CLIP's
tokenizer, text tower and visual tower (`clip_bpe`, `clip_text`,
`clip_visual`), and the representation zoo (`representations` over
`resnet`, `pointnet2`, `encoder2d`, `vit`)."""
from real_robot_nerf_actor_tpu_torch.models.blocks import (
    Conv3DBlock, Conv3DUpsampleBlock, DenseBlock, MultiLayer3DEncoderShallow)
from real_robot_nerf_actor_tpu_torch.models.nerf_field import (
    NerfFieldConfig, VoxelNerfField)
from real_robot_nerf_actor_tpu_torch.models.perceiver import (
    PerceiverConfig, PerceiverIO)
from real_robot_nerf_actor_tpu_torch.models.resnetfc import ResnetFC

__all__ = ["Conv3DBlock", "Conv3DUpsampleBlock", "DenseBlock", "MultiLayer3DEncoderShallow",
           "NerfFieldConfig", "PerceiverConfig", "PerceiverIO", "ResnetFC", "VoxelNerfField"]
