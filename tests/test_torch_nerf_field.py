"""VoxelNerfField of the PyTorch port against the flax VoxelNerfField, with
the flax variables converted by real_robot_nerf_actor_tpu_torch.convert:
full heads and compact heads, raw and corner-expanded grids, mask_outside.
Tolerances, of each output's largest magnitude: fp32 1e-5 (sums in
another order); bf16 3e-2 (the two frameworks round the bf16 layers'
outputs at other points, one bf16 ulp is 2^-8 and it compounds over six
layers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.models.nerf_field import NerfFieldConfig as JaxField
from real_robot_nerf_actor_tpu.models.nerf_field import VoxelNerfField as JaxNerf
from real_robot_nerf_actor_tpu.ops.grid_sample import expand_corners
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig, VoxelNerfField

KW = dict(d_latent=8, d_embed=16, d_hidden=32, n_blocks=3, combine_layer=2)


def _variables(net, seed=0):
    vox = jnp.zeros((1, 2, 2, 2, 8))
    xyz = jnp.zeros((1, 4, 3))
    params = net.init(jax.random.key(seed), vox, xyz, xyz, method=net.init_all)
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    # every weight random (flax zero-inits each block's second dense) at
    # std fan_in^-1/2, so activations stay O(1) through the blocks
    leaves = [jnp.asarray(rng.standard_normal(np.shape(x)).astype(np.float32)
                          * (np.shape(x)[0] ** -0.5 if np.ndim(x) == 2 else 0.1))
              for x in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("expanded", [False, True])
def test_field_matches_flax(dtype, tol, compact, expanded):
    cfg = dict(KW, compute_dtype=dtype, mask_outside=True, regress_coord=not compact)
    net = JaxNerf(JaxField(**cfg))
    variables = _variables(net)
    ours = VoxelNerfField(NerfFieldConfig(**cfg))
    ours.load_state_dict(flax_to_state_dict(jax.device_get(variables)))
    rng = np.random.default_rng(1)
    vox = rng.standard_normal((1, 6, 6, 6, 8)).astype(np.float32)
    lo, hi = np.array([-0.1, -0.3, -0.2]), np.array([0.8, 0.7, 0.7])
    xyz = rng.uniform(lo - 0.1, hi + 0.1, (1, 50, 3)).astype(np.float32)
    dirs = rng.standard_normal((1, 50, 3)).astype(np.float32)
    vox_j = jnp.asarray(vox)
    vox_t = torch.from_numpy(vox)
    if expanded:
        vox_j = expand_corners(vox_j)
        vox_t = torch.from_numpy(np.asarray(vox_j))
    want = net.apply(variables, vox_j, jnp.asarray(xyz), jnp.asarray(dirs),
                     expanded=expanded, compact_heads=compact)
    with torch.no_grad():
        got = ours(vox_t, torch.from_numpy(xyz), torch.from_numpy(dirs),
                   expanded=expanded, compact_heads=compact)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = got[k].float().numpy()
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=k)
    sig = got["sigma"].numpy()
    assert (sig == 0).any() and (sig > 0).any()       # the mask bites
