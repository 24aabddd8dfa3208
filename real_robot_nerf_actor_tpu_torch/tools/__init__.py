"""Measurement tools of the port, run on a CUDA card, and the tools that read
a trained checkpoint (eval_quality, analyze_bc, extract_nerf_feat; these take
--device cpu too): `python -m real_robot_nerf_actor_tpu_torch.tools.<name>`."""
