"""The renderer of the PyTorch port under grad against the JAX renderer:
`rendering_loss` (and the `render_rays` inside it) on the same voxel
features, field weights (converted from flax), view and draws, compared
with `jax.value_and_grad` of the JAX `rendering_loss`. The JAX key is split
as the JAX renderer splits it; its ray choice and sampler draws go to the
port through `ray_idx=` / `draws=`. Covered: the stratified path on the 8
gathers (late embed on and off) and the corner-expanded path with
`FUSED_LERP_BACKEND = "pallas"` (the port's `corner_lerp` runs its plain
version on the CPU, JAX's Pallas kernel runs in interpret mode), each with
the rgb, embed and masked depth terms.

The JAX renderer stops gradients at four places: the coarse depth that
centres the fine-depth samples (`renderer.py:593`), the weights of both
importance samplers (`sampling.py:33, 64`) and the canonical coordinates of
the field (`nerf_field.py:159`). The first changes the gradients of the
loss: without it they flow through the fine-depth sample positions into the
compositing, and `test_rendering_loss_matches_jax` fails. The samplers'
weights reach their samples only through integer bin indices, and the
canonical coordinates carry a gradient only if the sample positions do, so
those three are held directly: the samples and the field carry no gradient
to what the JAX package stops.

Tolerances (fp32): the loss and every metric 1e-5 relative; gradients 1e-4
of each tensor's largest |g|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.models.nerf_field import NerfFieldConfig as JaxField
from real_robot_nerf_actor_tpu.models.nerf_field import VoxelNerfField as JaxFieldModule
from real_robot_nerf_actor_tpu.ops import grid_sample as jg
from real_robot_nerf_actor_tpu.ops import sampling as js
from real_robot_nerf_actor_tpu.render import NeuralRenderer as JaxRenderer
from real_robot_nerf_actor_tpu.render import RendererConfig as JaxCfg
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
from real_robot_nerf_actor_tpu_torch.data.synthetic import _look_at
from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig, VoxelNerfField
from real_robot_nerf_actor_tpu_torch.ops import grid_sample as tg
from real_robot_nerf_actor_tpu_torch.ops import sampling as ts
from real_robot_nerf_actor_tpu_torch.render import NeuralRenderer, RendererConfig

BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
FIELD = dict(d_latent=8, d_embed=6, d_hidden=16, n_blocks=3, combine_layer=2,
             coord_bounds=BOUNDS, mask_outside=True)
RENDER = dict(image_width=8, image_height=8, z_near=0.9, z_far=2.2, n_coarse=6,
              n_fine=5, n_fine_depth=2, ray_chunk_size=24, lambda_depth=0.1,
              lambda_embed=0.5)
H = W = 8
FOCAL = 14.0
R = RENDER["ray_chunk_size"]


def _pose():
    center = np.array([0.35, 0.2, 0.1], np.float32)
    return _look_at(center + np.array([0.9, -0.75, 0.85], np.float32), center)[None]


def _field_params(jr, seed=0):
    """flax field weights, every leaf redrawn (flax zero-inits each block's
    second dense): kernels N(0, 1 / fan_in), biases N(0, 0.1^2), the
    density bias 3. Most rays are then nearly opaque, so their coarse depth
    (sum_k w_k z_k) lies between near and far: a depth under z_near would
    be clamped there by the fine-depth sampler, which cuts its gradient
    and would hide a missing detach."""
    params = jr.init_params(jax.random.key(seed))
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [jnp.asarray(rng.standard_normal(np.shape(x)).astype(np.float32)
                          * (np.shape(x)[0] ** -0.5 if np.ndim(x) == 2 else 0.1))
              for x in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    params["params"]["mlp_coarse"]["lin_out_bias"] = (
        params["params"]["mlp_coarse"]["lin_out_bias"].at[3].set(3.0))
    return params


def _view(seed=3):
    rng = np.random.default_rng(seed)
    vox = rng.standard_normal((1, 6, 6, 6, FIELD["d_latent"])).astype(np.float32)
    gt_rgb = rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    gt_embed = rng.standard_normal((1, H, W, FIELD["d_embed"])).astype(np.float32)
    gt_depth = rng.uniform(1.0, 2.6, (1, H, W)).astype(np.float32)   # some past z_far
    return vox, gt_rgb, gt_embed, gt_depth


def _draws(key, cfg):
    """rendering_loss's ray choice and render_rays' draws, in the JAX key order."""
    k_sel, k_render = jax.random.split(key)
    ray_idx = jax.random.randint(k_sel, (cfg.ray_chunk_size,), 0, H * W)
    k_coarse, k_fine, k_fdepth, _, _ = jax.random.split(k_render, 5)
    k_u, k_j = jax.random.split(k_fine)
    nf = cfg.n_fine - cfg.n_fine_depth
    d = {"coarse_u": jax.random.uniform(k_coarse, (R, cfg.n_coarse)),
         "fine_u": jax.random.uniform(k_u, (R, nf)),
         "fine_jitter": jax.random.uniform(k_j, (R, nf)),
         "fine_depth_eps": jax.random.normal(k_fdepth, (R, cfg.n_fine_depth))}
    return (torch.from_numpy(np.array(ray_idx)),
            {k: torch.from_numpy(np.array(v)) for k, v in d.items()})


@pytest.mark.parametrize("path,late_embed", [("stratified", True), ("stratified", False),
                                             ("expanded", True)])
def test_rendering_loss_matches_jax(monkeypatch, path, late_embed):
    expanded = path == "expanded"
    if expanded:
        monkeypatch.setattr(tg, "FUSED_LERP_BACKEND", "pallas")
        monkeypatch.setattr(jg, "FUSED_LERP_BACKEND", "pallas")
    rc = dict(RENDER, fused_gather=expanded, late_embed=late_embed)
    jr = JaxRenderer(JaxCfg(field=JaxField(**FIELD), **rc))
    tr = NeuralRenderer(RendererConfig(field=NerfFieldConfig(**FIELD), **rc), device="cpu")
    params = _field_params(jr)
    tr.load_field(flax_to_state_dict(jax.device_get(params)))
    vox, gt_rgb, gt_embed, gt_depth = _view()
    pose = _pose()
    key = jax.random.key(7)

    def loss(p, v):
        return jr.rendering_loss(p, v, jnp.asarray(gt_rgb), jnp.asarray(pose),
                                 jnp.asarray(FOCAL), key, gt_embed=jnp.asarray(gt_embed),
                                 gt_depth=jnp.asarray(gt_depth))

    (want, want_m), (want_gp, want_gv) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(vox))

    ray_idx, draws = _draws(key, jr.cfg)
    vt = torch.from_numpy(vox).requires_grad_()
    got, got_m = tr.rendering_loss(vt, torch.from_numpy(gt_rgb), torch.from_numpy(pose),
                                   FOCAL, gt_embed=torch.from_numpy(gt_embed),
                                   gt_depth=torch.from_numpy(gt_depth), ray_idx=ray_idx,
                                   draws=draws)
    got.backward()
    assert set(got_m) == set(want_m) and "loss_depth_fine" in got_m
    for k, w in want_m.items():
        np.testing.assert_allclose(got_m[k].item(), float(w), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)

    gv = np.asarray(want_gv)
    assert np.abs(gv).max() > 0
    np.testing.assert_allclose(vt.grad.numpy(), gv, rtol=0, atol=1e-4 * np.abs(gv).max())
    want_g = flax_to_state_dict(jax.device_get(want_gp))
    named = dict(tr.field.named_parameters())
    assert set(want_g) == set(named)
    for n, w in want_g.items():
        g = named[n].grad if named[n].grad is not None else torch.zeros_like(named[n])
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * w.abs().max().item() + 1e-30,
                                   msg=lambda m: f"{n}: {m}")


def test_samplers_and_field_stop_gradients_as_jax():
    """The importance samplers' weights and the field's canonical
    coordinates carry no gradient in either package."""
    rng = np.random.default_rng(4)
    rays = np.concatenate([rng.standard_normal((5, 6)), np.full((5, 1), 1.2),
                           np.full((5, 1), 4.0)], 1).astype(np.float32)
    wts = rng.uniform(0.01, 1.0, (5, 6)).astype(np.float32)
    z = np.sort(rng.uniform(1.2, 4.0, (5, 6)), -1).astype(np.float32)
    u = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    key = jax.random.key(0)
    jgrads = [
        jax.grad(lambda w: js.sample_fine(key, jnp.asarray(rays), w, 3, 6).sum())(
            jnp.asarray(wts)),
        jax.grad(lambda w: js.sample_importance_z(key, jnp.asarray(z), w, 3).sum())(
            jnp.asarray(wts)),
    ]
    assert all(float(jnp.abs(g).max()) == 0.0 for g in jgrads)
    wt = torch.from_numpy(wts).requires_grad_()
    for z_new in (ts.sample_fine(torch.from_numpy(rays), wt, 3, 6, u=torch.from_numpy(u),
                                 jitter=torch.from_numpy(u)),
                  ts.sample_importance_z(torch.from_numpy(z), wt, 3, u=torch.from_numpy(u),
                                         t=torch.from_numpy(u))):
        assert not z_new.requires_grad

    cfg = dict(FIELD, mask_outside=False)
    jf = JaxFieldModule(JaxField(**cfg))
    vox = rng.standard_normal((1, 4, 4, 4, 8)).astype(np.float32)
    xyz = rng.uniform(-0.1, 0.7, (1, 10, 3)).astype(np.float32)
    dirs = rng.standard_normal((1, 10, 3)).astype(np.float32)
    params = jf.init(jax.random.key(1), jnp.asarray(vox), jnp.asarray(xyz), jnp.asarray(dirs))
    gx = jax.grad(lambda x: jf.apply(params, jnp.asarray(vox), x, jnp.asarray(dirs))
                  ["sigma"].sum())(jnp.asarray(xyz))
    assert float(jnp.abs(gx).max()) == 0.0
    field = VoxelNerfField(NerfFieldConfig(**cfg))
    field.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    xt = torch.from_numpy(xyz).requires_grad_()
    out = field(torch.from_numpy(vox).requires_grad_(), xt, torch.from_numpy(dirs))
    out["sigma"].sum().backward()
    assert xt.grad is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expand_corners_to_matches_jax_vjp(dtype):
    """expand_corners_to(grid, dtype) is JAX's expand_corners(grid).astype
    (dtype), forward and backward (the backward sums the eight corner
    blocks in fp32, as JAX's backward of the cast and the expansion does):
    the output equal, the gradient within fp32 rounding of the sums."""
    rng = np.random.default_rng(5)
    grid = rng.standard_normal((1, 4, 5, 3, 6)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want, vjp = jax.vjp(lambda g: jg.expand_corners(g).astype(jdt), jnp.asarray(grid))
    cot = rng.standard_normal(want.shape).astype(np.float32)
    want_g, = vjp(jnp.asarray(cot).astype(jdt))
    gt = torch.from_numpy(grid).requires_grad_()
    got = tg.expand_corners_to(gt, tdt)
    assert got.dtype == tdt
    got.backward(torch.from_numpy(cot).to(tdt))
    np.testing.assert_array_equal(got.float().detach().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(want_g), rtol=0, atol=1e-5)


def test_corner_lerp_function_drops_d_w_of_a_weight_without_grad(monkeypatch):
    """On the render path the lerp weights carry no gradient (the field
    detaches the canonical coordinates): the CUDA branch's Function, run
    here through its plain launcher, still returns d_w, which autograd
    drops; d_rows is the JAX VJP's, and the backward is counted once."""
    from real_robot_nerf_actor_tpu_torch.ops import lerp_cuda
    monkeypatch.setattr(lerp_cuda, "_launch", lerp_cuda.corner_lerp_plain)
    rng = np.random.default_rng(6)
    rows = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.uniform(0, 1, (8, 40)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    calls = lerp_cuda.corner_lerp.vjp_calls
    lerp_cuda.CornerLerp.apply(rows, w).backward(g)
    assert lerp_cuda.corner_lerp.vjp_calls == calls + 1
    assert w.grad is None
    torch.testing.assert_close(rows.grad, lerp_cuda.corner_lerp_vjp(rows.detach(), w, g)[0],
                               rtol=0, atol=0)
