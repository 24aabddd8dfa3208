"""The voxel policy: PerceiverIO and its blocks."""
from real_robot_nerf_actor_tpu_torch.models.perceiver import (
    PerceiverConfig, PerceiverIO)

__all__ = ["PerceiverConfig", "PerceiverIO"]
