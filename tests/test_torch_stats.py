"""Spatial-softmax statistics of the PyTorch port: the plain version (what
the wrapper runs on a CPU tensor) against the JAX Pallas kernel under
force_tpu_interpret_mode, for fp32 and bf16 input; the keypoint wrapper
against both JAX keypoint paths; non-cubic input through the plain
spatial_softmax_3d. The Triton kernel is held against the plain version in
test_torch_kernels_cuda.py, on the card.

Tolerances: the sums are fp32 over V^3 terms in another order, 1e-5
relative; the keypoints (ratios in [-1, 1]) 1e-5 absolute. The plain
spatial_softmax_3d on bf16 subtracts the max in bf16 in both packages,
the same arithmetic, so 1e-5 holds there too. Inputs of scale 0.3 against
the temperature 0.01 leave each channel's sums to a few top rows; the
scale-0.01 case makes every row count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from real_robot_nerf_actor_tpu.ops.spatial_softmax import (
    spatial_softmax_3d as jax_ssm)
from real_robot_nerf_actor_tpu.ops.stats_pallas import (
    spatial_softmax_3d_pallas as jax_ssm_pallas, spatial_stats_3d as jax_stats)
from real_robot_nerf_actor_tpu_torch.ops.spatial_softmax import spatial_softmax_3d
from real_robot_nerf_actor_tpu_torch.ops.stats_cuda import (
    spatial_softmax_3d_pallas, spatial_stats_3d, spatial_stats_3d_plain)


def _feature(shape, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stats_match_jax_kernel(dtype):
    x = _feature((2, 8, 8, 8, 6))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_stats(jx))
        want_kp = np.asarray(jax_ssm_pallas(jx))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    launches = spatial_stats_3d.launches
    got = spatial_stats_3d(tx)
    assert spatial_stats_3d.launches == launches   # CPU: the plain version
    assert got.shape == (2, 6, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(spatial_softmax_3d_pallas(tx).numpy(), want_kp,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stats_match_jax_kernel_every_row_counts(dtype):
    """Spread of the input equal to the temperature: (x - max) / T is
    O(1), so every row adds to every sum."""
    x = _feature((2, 12, 12, 12, 5), seed=4, scale=0.01)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_stats(jx))
    got = spatial_stats_3d(torch.from_numpy(x).to(getattr(torch, dtype)))
    # each e <= 1: a denominator over 20 sums many rows, not one or two
    assert (want[..., 0] > 20).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 6), (1, 5, 7, 6, 3)])
def test_plain_spatial_softmax_matches_jax(dtype, shape):
    """Cubic and non-cubic volumes through the plain keypoint path."""
    x = _feature(shape, seed=1)
    want = np.asarray(jax_ssm(jnp.asarray(x, getattr(jnp, dtype))))
    got = spatial_softmax_3d(torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_kernel_keypoints_equal_plain_keypoints():
    """On a cubic fp32 volume the stats path gives the plain path's
    keypoints (the meshgrid('xy') axis order is the same)."""
    x = torch.from_numpy(_feature((1, 12, 12, 12, 5), seed=2))
    np.testing.assert_allclose(spatial_softmax_3d_pallas(x).numpy(),
                               spatial_softmax_3d(x).numpy(), rtol=0, atol=1e-5)

