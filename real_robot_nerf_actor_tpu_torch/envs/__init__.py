"""The MuJoCo xArm suite (counterpart of the JAX package's `envs/`): the
14 tasks, the raycast renderer and point clouds, and make_env's wrappers.
Needs `mujoco` and `gymnasium`; the rest of the package imports without
them, and importing this sub-package without them raises ImportError
naming the missing one."""
from real_robot_nerf_actor_tpu_torch.envs.base import XArmSimEnv, TASK_REGISTRY
from real_robot_nerf_actor_tpu_torch.envs.wrappers import make_env
from real_robot_nerf_actor_tpu_torch.envs.rendering import RaycastRenderer, PointCloudGenerator

__all__ = ["PointCloudGenerator", "RaycastRenderer", "TASK_REGISTRY", "XArmSimEnv", "make_env"]
