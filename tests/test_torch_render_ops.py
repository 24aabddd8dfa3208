"""Render ops of the PyTorch port against the JAX package, with the JAX
draws fed to the port's samplers: rays and positional encoding, the four
samplers, occupancy (pool, AABB, tighten, placement), compositing (sorted
and order-free) and trilinear grid sampling (8-gather and corner-expanded,
nested, flat and kernel lerps). All fp32; tolerance 1e-5 of each output's
scale (the same arithmetic, summed or fused in another order), indices and
integer grids exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.ops import compositing as jc
from real_robot_nerf_actor_tpu.ops import grid_sample as jg
from real_robot_nerf_actor_tpu.ops import occupancy as jo
from real_robot_nerf_actor_tpu.ops import rays as jr
from real_robot_nerf_actor_tpu.ops import sampling as js
from real_robot_nerf_actor_tpu_torch.ops import compositing as tc
from real_robot_nerf_actor_tpu_torch.ops import grid_sample as tg
from real_robot_nerf_actor_tpu_torch.ops import occupancy as to
from real_robot_nerf_actor_tpu_torch.ops import rays as tr
from real_robot_nerf_actor_tpu_torch.ops import sampling as ts

BOUNDS = np.array([-0.1, -0.3, -0.2, 0.8, 0.7, 0.7], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def _pose():
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array([[0.8, 0.0, 0.6], [0.0, 1.0, 0.0], [-0.6, 0.0, 0.8]])
    pose[:3, 3] = [0.4, 0.1, 2.0]
    return pose[None]


def _rays(n=48):
    return np.asarray(jr.gen_rays(jnp.asarray(_pose()), 8, 6, jnp.asarray(7.0), 1.2,
                                  4.0)).reshape(-1, 8)[:n]


@pytest.mark.parametrize("c", [None, (3.5, 2.0)])
def test_rays_and_posenc_match_jax(c):
    want = jr.gen_rays(jnp.asarray(_pose()), 8, 6, jnp.asarray(7.0), 1.2, 4.0, c=c)
    got = tr.gen_rays(_t(_pose()), 8, 6, 7.0, 1.2, 4.0, c=c)
    _close(got, want)
    x = np.random.default_rng(0).uniform(-1, 1, (5, 3)).astype(np.float32)
    for inc in (True, False):
        spec_j = jr.PositionalEncodingSpec(6, 3, 1.5, inc)
        spec_t = tr.PositionalEncodingSpec(6, 3, 1.5, inc)
        assert spec_t.d_out == spec_j.d_out
        _close(tr.positional_encoding(_t(x), spec_t),
               jr.positional_encoding(jnp.asarray(x), spec_j))


@pytest.mark.parametrize("lindisp", [False, True])
def test_samplers_match_jax(lindisp):
    rays = _rays()
    key = jax.random.key(3)
    b = rays.shape[0]
    want = js.sample_coarse(key, jnp.asarray(rays), 8, lindisp)
    _close(ts.sample_coarse(_t(rays), 8, lindisp,
                            u=_t(jax.random.uniform(key, (b, 8)))), want)
    w = np.random.default_rng(1).uniform(0, 1, (b, 8)).astype(np.float32)
    k_u, k_j = jax.random.split(key)
    u, jit = (_t(jax.random.uniform(k, (b, 5))) for k in (k_u, k_j))
    _close(ts.sample_fine(_t(rays), _t(w), 5, 8, lindisp, u=u, jitter=jit),
           js.sample_fine(key, jnp.asarray(rays), jnp.asarray(w), 5, 8, lindisp))
    z = np.sort(np.asarray(want), axis=-1)
    _close(ts.sample_importance_z(_t(z), _t(w), 5, u=u, t=jit),
           js.sample_importance_z(key, jnp.asarray(z), jnp.asarray(w), 5))
    depth = np.asarray(want)[:, 3]
    eps = _t(jax.random.normal(key, (b, 4)))
    _close(ts.sample_fine_depth(_t(rays), _t(depth), 4, 0.05, eps=eps),
           js.sample_fine_depth(key, jnp.asarray(rays), jnp.asarray(depth), 4, 0.05))


def test_sampler_draws_checked():
    with pytest.raises(ValueError, match="draws of shape"):
        ts.sample_coarse(_t(_rays()), 8, u=torch.zeros(3, 8))


def test_occupancy_matches_jax():
    rng = np.random.default_rng(0)
    occ = np.zeros((12, 12, 12), np.float32)
    occ[3:5, 6:9, 2:4] = 1.0
    occ[rng.integers(0, 12, 5), rng.integers(0, 12, 5), rng.integers(0, 12, 5)] = 1.0
    for pool, dil in ((4, 1), (2, 0), (3, 2)):
        pw = jo.pool_occupancy(jnp.asarray(occ), pool, dil)
        pt = to.pool_occupancy(_t(occ), pool, dil)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pw))
        np.testing.assert_array_equal(to.occupied_aabb(pt).numpy(),
                                      np.asarray(jo.occupied_aabb(pw)))
    empty = np.zeros((3, 3, 3), np.float32)
    np.testing.assert_array_equal(to.occupied_aabb(_t(empty)).numpy(),
                                  np.asarray(jo.occupied_aabb(jnp.asarray(empty))))
    pooled = np.asarray(jo.pool_occupancy(jnp.asarray(occ), 2, 1))
    aabb = np.asarray(jo.occupied_aabb(jnp.asarray(pooled)))
    rays = _rays()
    tw = jo.tighten_rays(jnp.asarray(rays), jnp.asarray(aabb), jnp.asarray(BOUNDS))
    tt = to.tighten_rays(_t(rays), _t(aabb), _t(BOUNDS))
    _close(tt, tw)
    assert (np.asarray(tw)[:, 7] > np.asarray(tw)[:, 6]).any()
    key = jax.random.key(4)
    k_u, k_j = jax.random.split(key)
    b = rays.shape[0]
    u, jit = (_t(jax.random.uniform(k, (b, 6))) for k in (k_u, k_j))
    _close(to.sample_occupancy(tt, _t(pooled), 6, _t(BOUNDS), 16, 0.002, u=u, jitter=jit),
           jo.sample_occupancy(key, tw, jnp.asarray(pooled), 6, jnp.asarray(BOUNDS), 16,
                               0.002))


def test_compositing_matches_jax():
    rng = np.random.default_rng(2)
    rays = _rays(16)
    z = np.sort(rng.uniform(1.2, 4.0, (16, 7)), axis=-1).astype(np.float32)
    sig = rng.uniform(-1, 30, (16, 7)).astype(np.float32)
    sig[0] = 1e4                                   # saturated alphas
    rgb = rng.uniform(0, 1, (16, 7, 3)).astype(np.float32)
    emb = rng.standard_normal((16, 7, 5)).astype(np.float32)
    for white in (False, True):
        want = jc.composite(jnp.asarray(z), jnp.asarray(rays), jnp.asarray(rgb),
                            jnp.asarray(sig), jnp.asarray(emb), white_bkgd=white)
        got = tc.composite(_t(z), _t(rays), _t(rgb), _t(sig), _t(emb), white_bkgd=white)
        for a, b in zip(got, want):
            _close(a, b)
        got_k = tc.composite(_t(z), _t(rays), _t(rgb), _t(sig),
                             _t(emb).permute(1, 0, 2), white_bkgd=white, embeds_kmajor=True)
        _close(got_k.embed, want.embed)
    perm = rng.permutation(7)
    z_u = z[:, perm].copy()
    z_u[:, 1] = z_u[:, 2]                          # a tie, broken by index
    _close(tc.compute_weights_unsorted(_t(z_u), _t(sig[:, perm]), _t(rays)),
           jc.compute_weights_unsorted(jnp.asarray(z_u), jnp.asarray(sig[:, perm]),
                                       jnp.asarray(rays)))


@pytest.mark.parametrize("mode", ["nested", "flat", "pallas"])
def test_grid_sample_matches_jax(mode, monkeypatch):
    rng = np.random.default_rng(5)
    grid = rng.standard_normal((2, 5, 6, 7, 4)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2, 40, 3)).astype(np.float32)
    _close(tg.grid_sample_3d(_t(grid), _t(coords)),
           jg.grid_sample_3d(jnp.asarray(grid), jnp.asarray(coords)))
    exp_j = jg.expand_corners(jnp.asarray(grid))
    exp_t = tg.expand_corners(_t(grid))
    _close(exp_t, exp_j, tol=0)
    if mode == "pallas":
        got = tg.grid_sample_3d_fused(exp_t, _t(coords), 4, backend="pallas")
        want = jg.grid_sample_3d_fused(exp_j, jnp.asarray(coords), 4, backend="pallas")
    else:
        monkeypatch.setattr(tg, "FUSED_LERP_MODE", mode)
        monkeypatch.setattr(jg, "FUSED_LERP_MODE", mode)
        got = tg.grid_sample_3d_fused(exp_t, _t(coords), 4)
        want = jg.grid_sample_3d_fused(exp_j, jnp.asarray(coords), 4)
    _close(got, want)
    # the expanded path equals the 8-gather path
    _close(got, jg.grid_sample_3d(jnp.asarray(grid), jnp.asarray(coords)))
    canon = (coords + 1) / 2
    _close(tg.sample_in_canonical_voxel(_t(grid), _t(canon)),
           jg.sample_in_canonical_voxel(jnp.asarray(grid), jnp.asarray(canon)))
