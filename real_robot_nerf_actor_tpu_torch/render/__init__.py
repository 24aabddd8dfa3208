"""The neural renderer: the serving frame of configs/serve.yaml and the
joint step's rendering loss."""
from real_robot_nerf_actor_tpu_torch.render.renderer import (
    NeuralRenderer, OccupancyState, RayPlan, RendererConfig, psnr)

__all__ = ["NeuralRenderer", "OccupancyState", "RayPlan", "RendererConfig", "psnr"]
