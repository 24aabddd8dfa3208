"""The serving renderer of the PyTorch port against the JAX NeuralRenderer:
a tiny serve.yaml-shaped renderer (occupancy sampling from the union of the
voxel channel and field probes, static int8 activation scales, RayPlan
culling, W8A8 int8 field, bf16; and once with the bf16 kernel path,
mlp_backend "pallas_bf16") through prepare -> calibrate_int8_act ->
plan_rays -> render_image in both packages, with the same weights
(converted from flax) and the same random draws (drawn with the JAX keys
and fed to the port). The port's kernel wrappers run their plain versions
here (CPU tensors); the JAX package's Pallas kernels run in interpret mode.

Tolerances: the occupancy grid and the plan's ray indices are equal; the
static scales agree to one bf16 ulp (2^-7 relative: the abs-max of bf16
activations whose fp32 sums run in another order; measured equal). The
frame: rgb 2e-3, depth 2e-3 and embed 5e-3 of their largest magnitude.
In int8 a sum that rounds one ulp apart in fp32 can move an activation to
the next int8 code, a step of 1/127 of its scale (measured gaps: rgb
4.5e-4, depth 6.2e-4 of 1.13, embed 3.0e-2 of 15.4). The stratified xla
path in fp32 is held to 1e-4 of each output's scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.models.nerf_field import NerfFieldConfig as JaxField
from real_robot_nerf_actor_tpu.ops import gen_rays as jax_gen_rays
from real_robot_nerf_actor_tpu.render import NeuralRenderer as JaxRenderer
from real_robot_nerf_actor_tpu.render import RendererConfig as JaxCfg
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
from real_robot_nerf_actor_tpu_torch.data.synthetic import _look_at
from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig
from real_robot_nerf_actor_tpu_torch.render import NeuralRenderer, RendererConfig

FIELD = dict(d_latent=8, d_embed=16, d_hidden=32, n_blocks=3, combine_layer=2,
             compute_dtype="bfloat16", mlp_backend="pallas_int8",
             int8_static_act=True, mask_outside=True)
RENDER = dict(image_width=16, image_height=16, n_coarse=6, n_fine=4,
              n_fine_depth=0, sampling_mode="occupancy", occ_source="auto",
              occ_pool=2, occ_probes=8, use_ray_plan=True, render_tile=64)
W = H = 16
FOCAL = 76.18 * 16 / 80.0


def _pose():
    center = np.array([0.35, 0.2, 0.1], np.float32)
    return _look_at(center + np.array([0.9, -0.75, 0.85], np.float32), center)[None]


def _scene(seed=1):
    rng = np.random.default_rng(seed)
    vox = rng.standard_normal((1, 8, 8, 8, 8)).astype(np.float32)
    occ = np.zeros((8, 8, 8), np.float32)
    occ[2:6, 2:6, 1:3] = 1.0
    return vox, occ


def _jax_params(jr, seed=0):
    params = jr.init_params(jax.random.key(seed))
    # random weights everywhere (flax zero-inits each block's second dense),
    # and a positive density bias so the frame is not empty
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [jnp.asarray(rng.standard_normal(np.shape(x)).astype(np.float32)
                          * (0.3 if np.ndim(x) == 2 else 0.05)) for x in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    params["params"]["mlp_coarse"]["lin_out_bias"] = (
        params["params"]["mlp_coarse"]["lin_out_bias"].at[3].set(1.0))
    return params


def _both(field_kw=None, render_kw=None):
    f = dict(FIELD, **(field_kw or {}))
    rc = dict(RENDER, **(render_kw or {}))
    jr = JaxRenderer(JaxCfg(field=JaxField(**f), **rc))
    tr = NeuralRenderer(RendererConfig(field=NerfFieldConfig(**f), **rc), device="cpu")
    params = _jax_params(jr)
    tr.load_field(flax_to_state_dict(jax.device_get(params)))
    return jr, tr, params


def _tile_draws(key, n_tiles, tile, cfg, probe=True):
    """The uniform draws JAX render_image takes per tile, in its key order."""
    out = []
    for kk in jax.random.split(key, n_tiles):
        k_coarse, k_fine, _, _, _ = jax.random.split(kk, 5)
        nf = cfg.n_fine - cfg.n_fine_depth
        if probe:
            k_u, k_j = jax.random.split(k_coarse)
            cu = jax.random.uniform(k_u, (tile, cfg.n_coarse))
            cj = jax.random.uniform(k_j, (tile, cfg.n_coarse))
        else:
            cu, cj = jax.random.uniform(k_coarse, (tile, cfg.n_coarse)), None
        k_u, k_j = jax.random.split(k_fine)
        d = {"coarse_u": cu, "fine_u": jax.random.uniform(k_u, (tile, nf)),
             "fine_jitter": jax.random.uniform(k_j, (tile, nf))}
        if cj is not None:
            d["coarse_jitter"] = cj
        out.append({k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})
    return out


def _serve_both(gather_fused, backend="pallas_int8"):
    jr, tr, params = _both({"gather_fused_mlp": gather_fused, "mlp_backend": backend})
    vox, occ_in = _scene()
    pose = _pose()
    vox_j, vox_t = jnp.asarray(vox), torch.from_numpy(vox)
    # 1. prepare (auto: voxel channel U field probes), same probe jitter
    occ_j = jr.prepare(params, vox_j, occupancy=jnp.asarray(occ_in))
    c = jr.cfg
    vp = 8 // c.occ_pool
    probe_u = np.array(jax.random.uniform(jax.random.key(0),
                                            (c.occ_field_probes, vp ** 3, 3)))
    occ_t = tr.prepare(vox_t, occupancy=torch.from_numpy(occ_in),
                       u=torch.from_numpy(probe_u))
    # 2. calibrate on the frame's rays, same subset and draws
    rays_j = jax_gen_rays(jnp.asarray(pose), W, H, jnp.asarray(FOCAL), c.z_near,
                          c.z_far).reshape(-1, 8)
    cal_key = jax.random.key(5)
    k_sub, k_z = jax.random.split(cal_key)
    n_cal = 64
    subset = np.asarray(jax.random.choice(k_sub, W * H, (n_cal,), replace=False))
    cal_u = np.asarray(jax.random.uniform(k_z, (n_cal, c.n_coarse + c.n_fine)))
    s_j = jr.calibrate_int8_act(params, vox_j, rays_j, key=cal_key, n_rays=n_cal)
    s_t = tr.calibrate_int8_act(vox_t, tr.frame_rays(pose, FOCAL), n_rays=n_cal,
                                subset=torch.from_numpy(subset).long(),
                                u=torch.from_numpy(cal_u))
    # 3. plan, 4. render
    plan_j = jr.plan_rays(occ_j, jnp.asarray(pose), jnp.asarray(FOCAL))
    plan_t = tr.plan_rays(occ_t, pose, FOCAL)
    key = jax.random.key(7)
    out_j = jr.render_image(params, vox_j, jnp.asarray(pose), jnp.asarray(FOCAL), key,
                            occ=occ_j, plan=plan_j)
    tile = min(c.render_tile, plan_t.idx.shape[0])
    draws = _tile_draws(key, plan_t.idx.shape[0] // tile, tile, c)
    out_t = tr.render_image(vox_t, pose, FOCAL, occ=occ_t, plan=plan_t, draws=draws)
    return (occ_j, occ_t), (s_j, s_t), (plan_j, plan_t), (out_j, out_t)


@pytest.mark.parametrize("gather_fused,backend", [(False, "pallas_int8"),
                                                  (True, "pallas_int8"),
                                                  (False, "pallas_bf16")])
def test_serving_slice_matches_jax(gather_fused, backend):
    (occ_j, occ_t), (s_j, s_t), (plan_j, plan_t), (out_j, out_t) = \
        _serve_both(gather_fused, backend)
    np.testing.assert_array_equal(occ_t.pooled.numpy(), np.asarray(occ_j.pooled))
    np.testing.assert_allclose(occ_t.aabb.numpy(), np.asarray(occ_j.aabb), atol=1e-7)
    np.testing.assert_allclose(s_t, s_j, rtol=2 ** -7)
    assert plan_t.n_active == plan_j.n_active and plan_t.n_total == plan_j.n_total
    assert 0 < plan_t.n_active < plan_t.n_total
    np.testing.assert_array_equal(plan_t.idx.numpy(), np.asarray(plan_j.idx))
    names = ("rgb", "embed", "depth")
    for name, a, b in zip(names, out_t, out_j):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape and np.isfinite(a).all()
        tol = {"rgb": 2e-3, "embed": 5e-3, "depth": 2e-3}[name] * max(1.0, np.abs(b).max())
        assert np.abs(a - b).max() <= tol, (name, np.abs(a - b).max(), tol)
    assert np.asarray(out_j[0]).max() > 0.05       # a live frame


def test_gather_fused_equals_unfused():
    """The gather-fused path gives the unfused frame exactly: the same lerp
    order and the same rounding points."""
    a, b = _serve_both(False)[3][1], _serve_both(True)[3][1]
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_culled_frame_equals_unculled():
    """plan_rays + render_image(plan) == render_image(occ) on a mask_outside
    field: culled rays are background either way (port of the JAX
    test_ray_plan_culled_render_matches_unculled, here with the same draws
    for the hit rays, so they agree exactly)."""
    _, tr, _ = _both()
    vox, occ_in = _scene()
    vox_t = torch.from_numpy(vox)
    occ = tr.prepare_occupancy(torch.from_numpy(occ_in))
    tr.calibrate_int8_act(vox_t, tr.frame_rays(_pose(), FOCAL), n_rays=64,
                          generator=torch.Generator().manual_seed(0))
    plan = tr.plan_rays(occ, _pose(), FOCAL)
    assert 0 < plan.n_active < plan.n_total
    c = tr.cfg
    n = W * H
    # one tile over the whole frame, so the draws of every ray are its own
    tr_one = NeuralRenderer(dataclasses.replace(c, render_tile=n), device="cpu")
    tr_one.load_field(tr.field.state_dict())
    tr_one._act_scales_t = tr._act_scales_t
    g = torch.Generator().manual_seed(3)
    full = {"coarse_u": torch.rand(n, c.n_coarse, generator=g),
            "coarse_jitter": torch.rand(n, c.n_coarse, generator=g),
            "fine_u": torch.rand(n, c.n_fine, generator=g),
            "fine_jitter": torch.rand(n, c.n_fine, generator=g)}
    a = tr_one.render_image(vox_t, _pose(), FOCAL, occ=occ, draws=[full])
    idx = plan.idx.clamp(max=n - 1)
    tile = min(c.render_tile, idx.shape[0])
    draws = [{k: v[idx[i:i + tile]] for k, v in full.items()}
             for i in range(0, idx.shape[0], tile)]
    b = tr.render_image(vox_t, _pose(), FOCAL, occ=occ, plan=plan, draws=draws)
    hit = torch.zeros(n, dtype=torch.bool)
    hit[plan.idx[:plan.n_active]] = True
    for x, y in zip(a, b):
        x, y = x.reshape(n, -1), y.reshape(n, -1)
        assert (y[~hit] == 0).all()
        assert x[~hit].abs().max() < 1e-5
        torch.testing.assert_close(x[hit], y[hit], rtol=0, atol=1e-6)


def test_stratified_xla_path_matches_jax_fp32():
    """The plain field path (mlp_backend "xla"), stratified sampling, fp32,
    on rays straight from gen_rays: render_rays in both packages."""
    kw = dict(compute_dtype="float32", mlp_backend="xla", int8_static_act=False,
              mask_outside=False)
    jr, tr, params = _both(kw, dict(sampling_mode="stratified", n_fine_depth=2,
                                    use_ray_plan=False))
    vox, _ = _scene()
    c = jr.cfg
    rays_j = jax_gen_rays(jnp.asarray(_pose()), W, H, jnp.asarray(FOCAL), c.z_near,
                          c.z_far).reshape(-1, 8)[:40]
    key = jax.random.key(2)
    out_j = jr.render_rays(params, jnp.asarray(vox), rays_j, key)
    k_coarse, k_fine, k_fdepth, _, _ = jax.random.split(key, 5)
    k_u, k_j = jax.random.split(k_fine)
    draws = {"coarse_u": jax.random.uniform(k_coarse, (40, c.n_coarse)),
             "fine_u": jax.random.uniform(k_u, (40, 2)),
             "fine_jitter": jax.random.uniform(k_j, (40, 2)),
             "fine_depth_eps": jax.random.normal(k_fdepth, (40, 2))}
    draws = {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}
    with torch.no_grad():
        out_t = tr.render_rays(torch.from_numpy(vox), torch.from_numpy(np.asarray(rays_j)),
                               draws=draws)
    for p in ("coarse", "fine"):
        for name in ("rgb", "embed", "depth", "weights"):
            a = getattr(out_t[p], name).numpy()
            b = np.asarray(getattr(out_j[p], name))
            np.testing.assert_allclose(a, b, atol=1e-4 * max(1.0, np.abs(b).max()),
                                       rtol=0, err_msg=f"{p} {name}")


def test_static_scales_required():
    _, tr, _ = _both()
    vox, occ_in = _scene()
    occ = tr.prepare_occupancy(torch.from_numpy(occ_in))
    with pytest.raises(RuntimeError, match="calibrate_int8_act"):
        tr.render_image(torch.from_numpy(vox), _pose(), FOCAL, occ=occ,
                        generator=torch.Generator().manual_seed(0))


def test_renderer_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NeuralRenderer(RendererConfig())


def test_init_params_draws_like_flax():
    """init_params: kaiming-normal dense weights, each block's second dense
    and every bias zero, as the flax field initialises."""
    tr = NeuralRenderer(RendererConfig(field=NerfFieldConfig(**FIELD)), device="cpu")
    tr.init_params(torch.Generator().manual_seed(0))
    mlp = tr.field.mlp_coarse
    w = mlp.ResnetBlockFC_0.Dense_0.weight
    assert abs(w.std().item() - (2.0 / 32) ** 0.5) < 0.05
    assert (mlp.ResnetBlockFC_0.Dense_1.weight == 0).all()
    assert (mlp.lin_out_bias == 0).all() and mlp.lin_out_kernel.abs().sum() > 0
