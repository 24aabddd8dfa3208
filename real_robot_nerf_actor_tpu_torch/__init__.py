"""PyTorch/CUDA port of real_robot_nerf_actor_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package imports torch and
numpy only. Module names follow the JAX package's layout, and the Pallas
TPU kernels on the ported path are hand-written Hopper kernels here
(`csrc/` and `ops/*_cuda.py`).
"""
