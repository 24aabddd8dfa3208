"""Config loading (the port's copy of the JAX package's utils/config.py),
the logger, profiling ranges and timers, the kernel build cache, PCA and
visualisation."""
from real_robot_nerf_actor_tpu_torch.utils.logger import AverageMeter, Logger
from real_robot_nerf_actor_tpu_torch.utils.profiling import StepTimer, named_scope

__all__ = ["AverageMeter", "Logger", "StepTimer", "named_scope"]
