"""The serving renderer of configs/serve.yaml."""
from real_robot_nerf_actor_tpu_torch.render.renderer import (
    NeuralRenderer, OccupancyState, RayPlan, RendererConfig, psnr)

__all__ = ["NeuralRenderer", "OccupancyState", "RayPlan", "RendererConfig", "psnr"]
