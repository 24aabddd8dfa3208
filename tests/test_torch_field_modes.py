"""The NeRF field's two opt-in modes in the PyTorch port, against the JAX
package: the proposal sampler (`use_proposal`: a small coarse MLP, the fine
pass compositing only its new samples, no coarse embed loss) and the W8A8
serving mode (`quantized`: ops/quant.int8_matmul inside QuantDense).

Tolerances (fp32): field outputs 1e-5 of each output's largest magnitude;
`rendering_loss` and its metrics 1e-5 relative, gradients 1e-4 of each
tensor's largest |g| (tests/test_torch_render_grad.py's bounds); the int8
operands and scales of `int8_matmul` equal, its output within 1e-5 of its
scale (the int32 products are exact in both packages; what is left is the
fp32 rescale). A quantized render against JAX's: rgb and depth 2e-3,
embed 5e-3 of their largest magnitude, as tests/test_torch_renderer.py
holds the int8 kernel frame: an fp32 sum upstream of a quantizer that
rounds one ulp apart can move an activation to the next int8 code, a step
of 1/127 of its row's scale (measured here: rgb 1.3e-4 in one of 192
values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.models.nerf_field import NerfFieldConfig as JaxField
from real_robot_nerf_actor_tpu.models.nerf_field import VoxelNerfField as JaxNerf
from real_robot_nerf_actor_tpu.models.resnetfc import ResnetFC as JaxResnetFC
from real_robot_nerf_actor_tpu.ops import gen_rays
from real_robot_nerf_actor_tpu.ops import quant as jq
from real_robot_nerf_actor_tpu.ops.grid_sample import expand_corners
from real_robot_nerf_actor_tpu.render import NeuralRenderer as JaxRenderer
from real_robot_nerf_actor_tpu.render import RendererConfig as JaxCfg
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
from real_robot_nerf_actor_tpu_torch.data.synthetic import _look_at
from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig, ResnetFC, VoxelNerfField
from real_robot_nerf_actor_tpu_torch.ops import quant as tq
from real_robot_nerf_actor_tpu_torch.render import NeuralRenderer, RendererConfig

BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
KW = dict(d_latent=8, d_embed=6, d_hidden=16, n_blocks=3, combine_layer=2,
          coord_bounds=BOUNDS, mask_outside=True, use_proposal=True,
          proposal_hidden=12, proposal_blocks=2)
RENDER = dict(image_width=8, image_height=8, z_near=0.9, z_far=2.2, n_coarse=6,
              n_fine=5, n_fine_depth=2, ray_chunk_size=24, lambda_depth=0.1,
              lambda_embed=0.5)
H = W = 8
FOCAL = 14.0
R = RENDER["ray_chunk_size"]


def _redraw(params, seed=0, density_bias=3.0):
    """Every leaf redrawn (flax zero-inits each block's second dense):
    kernels N(0, 1 / fan_in), biases N(0, 0.1^2); the density bias of each
    MLP set, so that most rays are nearly opaque."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [jnp.asarray(rng.standard_normal(np.shape(x)).astype(np.float32)
                          * (np.shape(x)[0] ** -0.5 if np.ndim(x) == 2 else 0.1))
              for x in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    for m in ("mlp_coarse", "mlp_proposal"):
        if m in params["params"]:
            params["params"][m]["lin_out_bias"] = (
                params["params"][m]["lin_out_bias"].at[3].set(density_bias))
    return params


def _pose():
    center = np.array([0.35, 0.2, 0.1], np.float32)
    return _look_at(center + np.array([0.9, -0.75, 0.85], np.float32), center)[None]


def _close(got, want, tol, msg=""):
    w = np.asarray(want, np.float32)
    g = np.asarray(got, np.float32)
    assert g.shape == w.shape, msg
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1.0, np.abs(w).max()), err_msg=msg)


@pytest.mark.parametrize("use_latent", [True, False])
@pytest.mark.parametrize("expanded", [False, True])
def test_proposal_field_pass_matches_flax(use_latent, expanded):
    cfg = dict(KW, proposal_use_latent=use_latent)
    net = JaxNerf(JaxField(**cfg))
    vox0, xyz0 = jnp.zeros((1, 2, 2, 2, 8)), jnp.zeros((1, 4, 3))
    variables = _redraw(net.init(jax.random.key(0), vox0, xyz0, xyz0, method=net.init_all))
    ours = VoxelNerfField(NerfFieldConfig(**cfg))
    ours.load_state_dict(flax_to_state_dict(jax.device_get(variables)))
    assert ours.mlp_proposal.d_latent == (8 if use_latent else 0)
    rng = np.random.default_rng(1)
    vox = rng.standard_normal((1, 6, 6, 6, 8)).astype(np.float32)
    lo, hi = np.array(BOUNDS[:3]), np.array(BOUNDS[3:])
    xyz = rng.uniform(lo - 0.1, hi + 0.1, (1, 50, 3)).astype(np.float32)
    dirs = rng.standard_normal((1, 50, 3)).astype(np.float32)
    vox_j = expand_corners(jnp.asarray(vox)) if expanded else jnp.asarray(vox)
    vox_t = torch.from_numpy(np.asarray(vox_j))
    for coarse in (True, False):
        want = net.apply(variables, vox_j, jnp.asarray(xyz), jnp.asarray(dirs),
                         coarse=coarse, expanded=expanded)
        with torch.no_grad():
            got = ours(vox_t, torch.from_numpy(xyz), torch.from_numpy(dirs), coarse=coarse,
                       expanded=expanded)
        assert set(got) == set(want)
        for k in want:
            _close(got[k].float(), want[k], 1e-5, f"coarse={coarse} {k}")
        if coarse:
            assert (got["embed"] == 0).all() and got["embed"].shape == (1, 50, 6)
            assert (got["sigma"] == 0).any() and (got["sigma"] > 0).any()


def _renderers(**field_kw):
    rc = dict(RENDER)
    jr = JaxRenderer(JaxCfg(field=JaxField(**dict(KW, **field_kw)), **rc))
    tr = NeuralRenderer(RendererConfig(field=NerfFieldConfig(**dict(KW, **field_kw)), **rc),
                        device="cpu")
    params = _redraw(jr.init_params(jax.random.key(0)))
    tr.load_field(flax_to_state_dict(jax.device_get(params)))
    return jr, tr, params


def _view(seed=3):
    rng = np.random.default_rng(seed)
    vox = rng.standard_normal((1, 6, 6, 6, KW["d_latent"])).astype(np.float32)
    gt_rgb = rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    gt_embed = rng.standard_normal((1, H, W, KW["d_embed"])).astype(np.float32)
    gt_depth = rng.uniform(1.0, 2.6, (1, H, W)).astype(np.float32)
    return vox, gt_rgb, gt_embed, gt_depth


def _render_draws(k_render, cfg, r):
    k_coarse, k_fine, k_fdepth, _, _ = jax.random.split(k_render, 5)
    k_u, k_j = jax.random.split(k_fine)
    nf = cfg.n_fine - cfg.n_fine_depth
    d = {"coarse_u": jax.random.uniform(k_coarse, (r, cfg.n_coarse)),
         "fine_u": jax.random.uniform(k_u, (r, nf)),
         "fine_jitter": jax.random.uniform(k_j, (r, nf)),
         "fine_depth_eps": jax.random.normal(k_fdepth, (r, cfg.n_fine_depth))}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("use_latent", [True, False])
def test_proposal_render_rays_matches_jax(use_latent):
    jr, tr, params = _renderers(proposal_use_latent=use_latent)
    vox = _view()[0]
    jr_rays = gen_rays(jnp.asarray(_pose()), W, H, jnp.asarray(FOCAL), RENDER["z_near"],
                       RENDER["z_far"]).reshape(-1, 8)[:20]
    key = jax.random.key(2)
    want = jr.render_rays(params, jnp.asarray(vox), jr_rays, key)
    rays = torch.from_numpy(np.array(jr_rays))
    with torch.no_grad():
        got = tr.render_rays(torch.from_numpy(vox), rays, draws=_render_draws(key, jr.cfg, 20))
    assert got["fine"].weights.shape == (20, RENDER["n_fine"])     # the new samples only
    for level in ("coarse", "fine"):
        for name in ("weights", "rgb", "embed", "depth"):
            _close(getattr(got[level], name), getattr(want[level], name), 1e-5,
                   f"{level} {name}")
    assert float(np.abs(np.asarray(want["coarse"].embed)).max()) == 0.0


@pytest.mark.parametrize("use_latent", [True, False])
def test_proposal_rendering_loss_and_grads_match_jax(use_latent):
    jr, tr, params = _renderers(proposal_use_latent=use_latent)
    vox, gt_rgb, gt_embed, gt_depth = _view()
    pose = _pose()
    key = jax.random.key(7)

    def loss(p, v):
        return jr.rendering_loss(p, v, jnp.asarray(gt_rgb), jnp.asarray(pose),
                                 jnp.asarray(FOCAL), key, gt_embed=jnp.asarray(gt_embed),
                                 gt_depth=jnp.asarray(gt_depth))

    (want, want_m), (want_gp, want_gv) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(vox))
    k_sel, k_render = jax.random.split(key)
    ray_idx = torch.from_numpy(np.array(jax.random.randint(k_sel, (R,), 0, H * W)))
    vt = torch.from_numpy(vox).requires_grad_()
    got, got_m = tr.rendering_loss(vt, torch.from_numpy(gt_rgb), torch.from_numpy(pose),
                                   FOCAL, gt_embed=torch.from_numpy(gt_embed),
                                   gt_depth=torch.from_numpy(gt_depth), ray_idx=ray_idx,
                                   draws=_render_draws(k_render, jr.cfg, R))
    got.backward()
    assert set(got_m) == set(want_m) and "loss_embed_coarse" not in got_m
    for k, w in want_m.items():
        np.testing.assert_allclose(got_m[k].item(), float(w), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    gv = np.asarray(want_gv)
    assert np.abs(gv).max() > 0
    np.testing.assert_allclose(vt.grad.numpy(), gv, rtol=0, atol=1e-4 * np.abs(gv).max())
    want_g = flax_to_state_dict(jax.device_get(want_gp))
    named = dict(tr.field.named_parameters())
    assert set(want_g) == set(named) and any(n.startswith("mlp_proposal.") for n in named)
    for n, w in want_g.items():
        g = named[n].grad if named[n].grad is not None else torch.zeros_like(named[n])
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * w.abs().max().item() + 1e-30,
                                   msg=lambda m: f"{n}: {m}")
    # the proposal MLP learns through the coarse rgb and depth terms
    assert named["mlp_proposal.lin_out_kernel"].grad.abs().max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 24)).astype(np.float32)
    x[3] = 0.0                                           # a zero row: the eps scale
    w = rng.standard_normal((24, 20)).astype(np.float32) * 0.2
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    for jfn, tfn, a, b in ((jq.quantize_rows, tq.quantize_rows, xj, xt),
                           (jq.quantize_cols, tq.quantize_cols, jnp.asarray(w),
                            torch.from_numpy(w))):
        (jqv, js), (tqv, ts) = jfn(a), tfn(b)
        assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    want = np.asarray(jq.int8_matmul(xj, jnp.asarray(w), out_dtype=jdt), np.float32)
    got = tq.int8_matmul(xt, torch.from_numpy(w), out_dtype=tdt).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_round_is_half_even():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
    q, s = tq.quantize_rows(x * (127.0 / 127.0))
    jqv, _ = jq.quantize_rows(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2 ** -6)])
def test_quantized_resnetfc_matches_jax(dtype, tol):
    """The same flax tree serves both the fp32 and the quantized ResnetFC."""
    kw = dict(d_out=4, n_blocks=3, d_latent=8, d_hidden=64, combine_layer=2)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    mlp_q = JaxResnetFC(**kw, quantized=True, dtype=jdt)
    zx = jax.random.normal(jax.random.key(0), (32, 13))
    params = _redraw(JaxResnetFC(**kw).init(jax.random.key(1), zx))
    want = np.asarray(mlp_q.apply(params, zx)[0], np.float32)
    ours = ResnetFC(d_in=5, **kw, quantized=True, dtype=tdt)
    ours.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    assert type(ours.ResnetBlockFC_0.Dense_0).__name__ == "QuantDense"
    with torch.no_grad():
        got = ours(torch.from_numpy(np.asarray(zx)))[0].float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    plain = ResnetFC(d_in=5, **kw, dtype=tdt)
    plain.load_state_dict(ours.state_dict())
    with torch.no_grad():
        ref = plain(torch.from_numpy(np.asarray(zx)))[0].float().numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert 0 < err < 0.05, err          # quantized, and close to the fp32 product


def test_quantized_backward_raises_as_jax():
    x = torch.randn(20, 16, requires_grad=True)
    w = torch.randn(16, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="serving-only"):
        tq.int8_matmul(x, w).sum().backward()
    field = VoxelNerfField(NerfFieldConfig(d_latent=8, d_embed=6, d_hidden=16, n_blocks=2,
                                           combine_layer=1, quantized=True))
    from real_robot_nerf_actor_tpu_torch.models.blocks import init_weights
    init_weights(field, torch.Generator().manual_seed(0))
    vox = torch.randn(1, 4, 4, 4, 8, requires_grad=True)
    xyz = torch.rand(1, 10, 3) * 0.5
    out = field(vox, xyz, torch.randn(1, 10, 3))
    with pytest.raises(NotImplementedError, match="serving-only"):
        out["rgb"].sum().backward()
    with torch.no_grad():                       # serving: no graph, no guard
        assert torch.isfinite(field(vox, xyz, torch.randn(1, 10, 3))["sigma"]).all()


def test_quantized_frame_matches_jax():
    """A whole quantized render_image (the plain xla field, fp32) in both
    packages, same weights and draws."""
    rc = dict(RENDER, render_tile=32)
    fk = dict(KW, use_proposal=False, quantized=True)
    jr = JaxRenderer(JaxCfg(field=JaxField(**fk), **rc))
    tr = NeuralRenderer(RendererConfig(field=NerfFieldConfig(**fk), **rc), device="cpu")
    params = _redraw(jr.init_params(jax.random.key(0)))
    tr.load_field(flax_to_state_dict(jax.device_get(params)))
    vox = _view()[0]
    pose = _pose()
    key = jax.random.key(5)
    want = jr.render_image(params, jnp.asarray(vox), jnp.asarray(pose), jnp.asarray(FOCAL),
                           key)
    n_tiles = H * W // 32
    draws = [_render_draws(k, jr.cfg, 32) for k in jax.random.split(key, n_tiles)]
    got = tr.render_image(torch.from_numpy(vox), torch.from_numpy(pose), FOCAL, draws=draws)
    for name, g, w, tol in zip(("rgb", "embed", "depth"), got, want, (2e-3, 5e-3, 2e-3)):
        _close(g, w, tol, name)
    # and it is the quantized field: the fp32 field renders another frame
    plain = NeuralRenderer(RendererConfig(field=NerfFieldConfig(**dict(fk, quantized=False)),
                                          **rc), device="cpu")
    plain.load_field(tr.field.state_dict())
    ref = plain.render_image(torch.from_numpy(vox), torch.from_numpy(pose), FOCAL, draws=draws)
    assert (ref[0] - got[0]).abs().max() > 1e-5


@pytest.mark.parametrize("backend", ["pallas_bf16", "pallas_int8"])
def test_fused_backend_composes_with_proposal_mode(backend):
    """As the JAX package's test of the same name: the proposal coarse pass
    on the plain field, the fine pass on the fused backend (its plain
    versions here), finite and within 0.03 of the plain proposal render;
    the fused path runs once a render_rays, for the fine pass."""
    field = dict(d_latent=8, d_embed=16, d_hidden=32, n_blocks=3, combine_layer=2,
                 use_proposal=True, proposal_hidden=16, proposal_blocks=1)
    rc = dict(image_width=8, image_height=8, n_coarse=6, n_fine=4, n_fine_depth=0)
    jr = JaxRenderer(JaxCfg(field=JaxField(**field), **rc))
    params = jr.init_params(jax.random.key(0))
    for m in ("mlp_coarse", "mlp_proposal"):
        params["params"][m]["lin_out_bias"] = params["params"][m]["lin_out_bias"].at[3].set(1.0)
    sd = flax_to_state_dict(jax.device_get(params))
    plain = NeuralRenderer(RendererConfig(field=NerfFieldConfig(**field), **rc), device="cpu")
    fused = NeuralRenderer(RendererConfig(field=NerfFieldConfig(**field, mlp_backend=backend),
                                          **rc), device="cpu")
    plain.load_field(sd)
    fused.load_field(sd)
    vox = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 6, 6, 6, 8))
                           .astype(np.float32))
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 2.5
    rays = plain.frame_rays(pose[None], 7.0)
    draws = _render_draws(jax.random.key(2), jr.cfg, rays.shape[0])
    calls = []
    inner = fused._eval_points_fused_int8
    fused._eval_points_fused_int8 = lambda *a: (calls.append(1), inner(*a))[1]
    with torch.no_grad():
        a = plain.render_rays(vox, rays, draws=draws)["fine"].rgb
        b = fused.render_rays(vox, rays, draws=draws)["fine"].rgb
    assert len(calls) == 1 and torch.isfinite(b).all()
    assert (a - b).abs().max() < 0.03, (a - b).abs().max()
