"""A frozen copy of the port's plain paths, the yardstick's reference.

Copied from `real_robot_nerf_actor_tpu_torch` with the package name
rewritten, and cut to the plain paths that the two references run: the
kernel wrappers (`ops/*_cuda.py`), their builder, the int8 field and its
packing are left out, and each model refuses the knob that would select
them. So the reference computes with plain PyTorch alone, and a later
change to the port cannot move it. It imports nothing of the port.

When it was frozen, the port's CPU tests held each of these paths against
the JAX package (module of this copy: the tests in `tests/`):

- `models/blocks.py`: `test_torch_blocks.py`;
- `models/perceiver.py`, with `ops/attention.py` and
  `ops/spatial_softmax.py`: `test_torch_policy.py::test_policy_matches_jax`,
  `test_torch_attention.py::test_reference_attention_matches_jax`,
  `test_torch_stats.py::test_plain_spatial_softmax_matches_jax`;
- `models/nerf_field.py`, `models/resnetfc.py`:
  `test_torch_nerf_field.py::test_field_matches_flax`;
- `render/renderer.py`: `test_torch_renderer.py::test_stratified_xla_path_matches_jax_fp32`,
  `test_torch_render_grad.py::test_rendering_loss_matches_jax`;
- `ops/rays.py`, `sampling.py`, `occupancy.py`, `compositing.py`,
  `grid_sample.py`: `test_torch_render_ops.py`;
- `ops/voxelize.py`, `geometry.py`, `action_codec.py`: `test_torch_ops.py`;
- `ops/se3_aug.py`: `test_torch_train_peract.py::test_se3_augmentation_matches_jax`;
- the joint step the train reference rebuilds from these parts:
  `test_torch_train_nerfact.py::test_train_step_matches_jax`.
"""
