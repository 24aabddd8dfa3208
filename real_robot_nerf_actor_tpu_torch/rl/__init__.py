"""Reinforcement learning: SAC on pixels or states, replay buffers, and
diffusion BC / Q-learning (`rl.diffusion_bc`)."""
from real_robot_nerf_actor_tpu_torch.rl.replay import PrioritizedReplayBuffer, ReplayBuffer
from real_robot_nerf_actor_tpu_torch.rl.sac import SACAgent, SACConfig

__all__ = ["PrioritizedReplayBuffer", "ReplayBuffer", "SACAgent", "SACConfig"]
