"""PerAct configuration (the port's copy of `PerActConfig` from the JAX
package's `train/peract.py`; the BC trainer comes with the training slice).
Same fields and meanings, so `configs/peract.yaml` and the `peract:`
section of `configs/serve.yaml` load into both packages."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from real_robot_nerf_actor_tpu_torch.models.perceiver import PerceiverConfig
from real_robot_nerf_actor_tpu_torch.ops.voxelize import VoxelizerSpec
from real_robot_nerf_actor_tpu_torch.train.trainer import TrainConfig


@dataclasses.dataclass(frozen=True)
class PerActConfig:
    model: PerceiverConfig = dataclasses.field(default_factory=PerceiverConfig)
    voxelizer: VoxelizerSpec = dataclasses.field(default_factory=VoxelizerSpec)
    coord_bounds: Tuple[float, ...] = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
    rotation_resolution: float = 5.0
    trans_aug_range: Tuple[float, float, float] = (0.125, 0.05, 0.05)
    use_se3_aug: bool = True
    lambda_aux_trans: float = 0.5
    trans_label_smooth: float = 0.0
    z_loss: float = 0.0
    se3_symmetric_clamp: bool = True
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
