"""NeRF-Actor configuration (the port's copy of `NerfActConfig` from the
JAX package's `train/nerfact.py`), so the whole of `configs/nerfact.yaml`
and `configs/serve.yaml` loads into the port. The joint trainer comes with
the training slice."""
from __future__ import annotations

import dataclasses

from real_robot_nerf_actor_tpu_torch.models.perceiver import PerceiverConfig
from real_robot_nerf_actor_tpu_torch.render.renderer import RendererConfig
from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig


@dataclasses.dataclass(frozen=True)
class NerfActConfig:
    peract: PerActConfig = dataclasses.field(default_factory=lambda: PerActConfig(
        model=PerceiverConfig(input_encoder="unet", return_voxel_feat=True)))
    renderer: RendererConfig = dataclasses.field(default_factory=RendererConfig)
    lambda_bc: float = 1.0
    lambda_nerf: float = 10.0
