"""Measurement tools of the port, run on a CUDA card (`python -m
real_robot_nerf_actor_tpu_torch.tools.<name>`)."""
