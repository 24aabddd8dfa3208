"""The voxel policy (PerceiverIO and its blocks), the NeRF field, CLIP's
tokenizer, text tower and visual tower (`clip_bpe`, `clip_text`,
`clip_visual`), and the representation zoo (`representations` over
`resnet`, `pointnet2`, `encoder2d`, `vit`), the pixelNeRF family's
`ImplicitNet`, and the auxiliary heads (`cnn_policies`, `vl_attention`,
the deep UNet `MultiLayer3DEncoder`)."""
from real_robot_nerf_actor_tpu_torch.models.blocks import (
    Conv3DBlock, Conv3DUpsampleBlock, DenseBlock, MultiLayer3DEncoder,
    MultiLayer3DEncoderShallow)
from real_robot_nerf_actor_tpu_torch.models.implicit import ImplicitNet
from real_robot_nerf_actor_tpu_torch.models.nerf_field import (
    NerfFieldConfig, VoxelNerfField)
from real_robot_nerf_actor_tpu_torch.models.perceiver import (
    PerceiverConfig, PerceiverIO)
from real_robot_nerf_actor_tpu_torch.models.resnetfc import ResnetFC

__all__ = ["Conv3DBlock", "Conv3DUpsampleBlock", "DenseBlock", "ImplicitNet",
           "MultiLayer3DEncoder", "MultiLayer3DEncoderShallow", "NerfFieldConfig", "PerceiverConfig", "PerceiverIO", "ResnetFC", "VoxelNerfField"]
