"""Ops of the PyTorch port against the JAX package: voxelization (with
padding rows and out-of-bound points), voxel geometry and the action codec.
All fp32: the same arithmetic on the same inputs, so voxel means agree to
fp32 rounding of the scatter sums (1e-6) and indices exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.ops import (
    VoxelizerSpec as JaxSpec, choose_highest_action as jax_choose,
    discretize_action as jax_discretize, voxelize as jax_voxelize)
from real_robot_nerf_actor_tpu.ops.geometry import (
    point_to_voxel_index as jax_p2v, voxel_index_to_point as jax_v2p)
from real_robot_nerf_actor_tpu_torch.ops import (
    VoxelizerSpec, argmax_3d, choose_highest_action, discretize_action,
    point_to_voxel_index, voxel_index_to_point, voxelize)

BOUNDS = np.array([-0.1, -0.3, -0.2, 0.8, 0.7, 0.7], np.float32)


def _cloud(n=3000, seed=0, pad=500):
    rng = np.random.default_rng(seed)
    lo, hi = BOUNDS[:3], BOUNDS[3:]
    span = hi - lo
    # 10% of the points fall outside the bounds on some axis
    pts = rng.uniform(lo - 0.1 * span, hi + 0.1 * span, (2, n, 3)).astype(np.float32)
    cols = rng.uniform(-1, 1, (2, n, 3)).astype(np.float32)
    valid = np.ones((2, n), bool)
    valid[:, n - pad:] = False
    pts[:, n - pad:] = 0.0    # padding rows at the origin, inside the bounds
    return pts, cols, valid


@pytest.mark.parametrize("with_valid", [True, False])
def test_voxelize_matches_jax(with_valid):
    pts, cols, valid = _cloud()
    v = None if not with_valid else valid
    want = np.asarray(jax_voxelize(jnp.asarray(pts), jnp.asarray(cols),
                                   jnp.asarray(BOUNDS), JaxSpec(voxel_size=12),
                                   valid=None if v is None else jnp.asarray(v)))
    got = voxelize(torch.from_numpy(pts), torch.from_numpy(cols),
                   torch.from_numpy(BOUNDS), VoxelizerSpec(voxel_size=12),
                   valid=None if v is None else torch.from_numpy(v))
    assert got.shape == (2, 12, 12, 12, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_voxelize_padding_adds_nothing():
    """Padding rows at the origin must not occupy the origin's voxel."""
    pts, cols, valid = _cloud(n=100, pad=50)
    spec = VoxelizerSpec(voxel_size=12)
    full = voxelize(torch.from_numpy(pts), torch.from_numpy(cols),
                    torch.from_numpy(BOUNDS), spec, valid=torch.from_numpy(valid))
    cut = voxelize(torch.from_numpy(pts[:, :50]), torch.from_numpy(cols[:, :50]),
                   torch.from_numpy(BOUNDS), spec)
    torch.testing.assert_close(full, cut)


def test_geometry_matches_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.3, 0.9, (64, 3)).astype(np.float32)
    want = np.asarray(jax_p2v(jnp.asarray(pts), 100, jnp.asarray(BOUNDS)))
    got = point_to_voxel_index(torch.from_numpy(pts), 100, torch.from_numpy(BOUNDS))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    idx = rng.integers(0, 100, (64, 3)).astype(np.int32)
    np.testing.assert_allclose(
        voxel_index_to_point(torch.from_numpy(idx), 100, torch.from_numpy(BOUNDS)).numpy(),
        np.asarray(jax_v2p(jnp.asarray(idx), 100, jnp.asarray(BOUNDS))),
        rtol=0, atol=1e-6)


def test_discretize_matches_jax():
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-0.1, 0.7, (16, 3)).astype(np.float32)
    # negative angles: the int cast truncates toward zero in both packages
    rot = rng.uniform(-180, 179, (16, 3)).astype(np.float32)
    grip = rng.integers(0, 2, 16).astype(np.float32)
    coll = rng.integers(0, 2, 16).astype(np.float32)
    want = jax_discretize(*map(jnp.asarray, (xyz, rot, grip, coll, BOUNDS)), 100, 5.0)
    got = discretize_action(*map(torch.from_numpy, (xyz, rot, grip, coll, BOUNDS)),
                            100, 5.0)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_decode_matches_jax():
    rng = np.random.default_rng(3)
    q_trans = rng.standard_normal((3, 6, 7, 8)).astype(np.float32)
    q_trans[0, 2, 3, 4] = q_trans[0, 5, 6, 7] = 10.0       # tie: first wins
    q_rot_grip = rng.standard_normal((3, 3 * 72 + 2)).astype(np.float32)
    q_coll = rng.standard_normal((3, 2)).astype(np.float32)
    want = jax_choose(*map(jnp.asarray, (q_trans, q_rot_grip, q_coll)), 5.0)
    got = choose_highest_action(*map(torch.from_numpy, (q_trans, q_rot_grip, q_coll)), 5.0)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert argmax_3d(torch.from_numpy(q_trans))[0].tolist() == [2, 3, 4]
    assert argmax_3d(torch.from_numpy(q_trans)[..., None]).shape == (3, 3)
