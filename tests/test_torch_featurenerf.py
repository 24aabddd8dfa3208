"""The FeatureNeRF slice of the PyTorch port against the JAX package, at a
tiny size (encoder stages (4, 4, 8) of one block, field 16 x 2 blocks,
combine at block 1, d_embed 6, 16 x 16 views): the same weights (JAX's
trees redrawn with numpy, converted by convert.pixelnerf_to_state_dict),
the same inputs from numpy seeds, and the JAX key's draws fed to the port
through `draws=` / `render_draws=` / `aug_noise=`. The JAX step's gradients
come out through an optax transform that keeps them as its state.

Tolerances (fp32): forwards 1e-5 of the output's largest |value|; a train
step's losses 1e-5 relative, its gradients 1e-4 of each tensor's largest
|g|, the parameters after AdamW as test_torch_train_nerfact holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from real_robot_nerf_actor_tpu.data import scene_dataset as jsd
from real_robot_nerf_actor_tpu.eval import correspondence as jcorr
from real_robot_nerf_actor_tpu.eval import extract as jext
from real_robot_nerf_actor_tpu.eval.metrics import ssim_np as jax_ssim
from real_robot_nerf_actor_tpu.models import encoder2d as je
from real_robot_nerf_actor_tpu.models.pixelnerf import PixelNerfConfig as JaxNetCfg
from real_robot_nerf_actor_tpu.models.pixelnerf import PixelNerfNet as JaxNet
from real_robot_nerf_actor_tpu.models.resnetfc import ResnetFC as JaxResnetFC
from real_robot_nerf_actor_tpu.render.pixelnerf_renderer import (
    PixelNerfRenderer as JaxRenderer)
from real_robot_nerf_actor_tpu.render.pixelnerf_renderer import (
    PixelNerfRendererConfig as JaxRenderCfg)
from real_robot_nerf_actor_tpu.train import featurenerf as jfn
from real_robot_nerf_actor_tpu.train.trainer import OptimConfig as JaxOptim
from real_robot_nerf_actor_tpu.train.trainer import TrainConfig as JaxTrainCfg
from real_robot_nerf_actor_tpu.train.trainer import TrainState as JaxState
from real_robot_nerf_actor_tpu.train.trainer import make_optimizer
from real_robot_nerf_actor_tpu_torch.convert import (
    flax_to_state_dict, load_optax_state, pixelnerf_to_state_dict)
from real_robot_nerf_actor_tpu_torch.data import scene_dataset as tsd
from real_robot_nerf_actor_tpu_torch.eval import correspondence as tcorr
from real_robot_nerf_actor_tpu_torch.eval import extract as text
from real_robot_nerf_actor_tpu_torch.eval import novel
from real_robot_nerf_actor_tpu_torch.eval.metrics import ssim_np
from real_robot_nerf_actor_tpu_torch.models import encoder2d as te
from real_robot_nerf_actor_tpu_torch.models.pixelnerf import PixelNerfConfig, PixelNerfNet
from real_robot_nerf_actor_tpu_torch.models.resnetfc import ResnetFC
from real_robot_nerf_actor_tpu_torch.ops.resize import resize
from real_robot_nerf_actor_tpu_torch.render.pixelnerf_renderer import (
    PixelNerfRenderer, PixelNerfRendererConfig)
from real_robot_nerf_actor_tpu_torch.train import featurenerf as tfn
from real_robot_nerf_actor_tpu_torch.train.trainer import OptimConfig, TrainConfig

ENC = dict(stage_features=(4, 4, 8), blocks_per_stage=1)
NET = dict(d_embed=6, d_hidden=16, n_blocks=2, combine_layer=1)
RENDER = dict(n_coarse=6, n_fine=4, n_fine_depth=2)
HW = (16, 16)
FOCAL = 20.0
t = torch.from_numpy


def _net_cfgs(**kw):
    jc = JaxNetCfg(encoder=je.SpatialEncoderConfig(**ENC), **NET, **kw)
    tc = PixelNerfConfig(encoder=te.SpatialEncoderConfig(**ENC), **NET, **kw)
    return jc, tc


def _redraw(tree, rng):
    """Every leaf redrawn with numpy: kernels N(0, 1 / fan_in), scales
    1 + N(0, 0.1^2), running means N(0, 0.3^2), variances U(0.5, 1.5),
    other vectors N(0, 0.1^2)."""
    def draw(path, a):
        name, s = path[-1].key, np.shape(a)
        if name == "var":
            x = rng.uniform(0.5, 1.5, s)
        elif name == "mean":
            x = 0.3 * rng.standard_normal(s)
        elif len(s) >= 2:
            x = rng.standard_normal(s) / np.sqrt(np.prod(s[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(s)
        else:
            x = 0.1 * rng.standard_normal(s)
        return jnp.asarray(x, jnp.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


def _jax_net(jc, seed=0):
    net = JaxNet(jc)
    v = net.init(jax.random.key(0), jnp.zeros((1, *HW, 3)), jnp.eye(4)[None],
                 jnp.asarray([1.0, -1.0]), jnp.zeros(2), jnp.zeros((8, 3)), jnp.zeros((8, 3)),
                 method=net.encode_and_query)
    rng = np.random.default_rng(seed)
    params = _redraw(v["params"], rng)
    params["mlp"]["lin_out_bias"] = params["mlp"]["lin_out_bias"].at[3].set(1.0)
    return net, {"params": params, "batch_stats": _redraw(v["batch_stats"], rng)}


def _port_net(tc, variables):
    net = PixelNerfNet(tc)
    net.load_state_dict(pixelnerf_to_state_dict(variables["params"], variables))
    return net


def _close(got, want, scale=None, tol=1e-5, msg=""):
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale + 1e-30,
                               err_msg=msg)


def _views(rng, nv=3):
    """nv cameras on a ring around the origin at radius 2, looking at it,
    and images in [0, 1]."""
    from real_robot_nerf_actor_tpu_torch.data.synthetic import make_camera_arc
    poses = make_camera_arc(nv, center=(0.0, 0.0, 0.0), radius=2.0, height=0.5)
    return rng.uniform(0, 1, (nv, *HW, 3)).astype(np.float32), poses.astype(np.float32)


# ------------------------------------------------------------------ encoder
@pytest.mark.parametrize("n_in,n_out", [(4, 15), (5, 16), (10, 7), (10, 8), (7, 7)])
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_resize_matches_jax_image_resize(method, n_in, n_out):
    """ops.resize equals jax.image.resize on both axes, borders included,
    antialiased when an axis shrinks."""
    x = np.random.default_rng(0).standard_normal((2, n_in, n_in + 3, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, n_out, n_out + 1, 3), method=method)
    got = resize(t(x), (n_out, n_out + 1), method)
    _close(got, want)


@pytest.mark.parametrize("hw", [(32, 40), (30, 38)])
@pytest.mark.parametrize("train", [False, True])
def test_spatial_encoder_matches_jax(train, hw):
    """SpatialEncoder on running statistics (train=False) and on batch
    statistics, with the running update at flax's momentum 0.99."""
    cfg = je.SpatialEncoderConfig(**ENC)
    enc = je.SpatialEncoder(cfg)
    x = np.random.default_rng(1).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    v = enc.init(jax.random.key(0), jnp.asarray(x))
    rng = np.random.default_rng(2)
    v = {"params": _redraw(v["params"], rng), "batch_stats": _redraw(v["batch_stats"], rng)}
    ours = te.SpatialEncoder(te.SpatialEncoderConfig(**ENC))
    ours.load_state_dict(flax_to_state_dict(v))
    if train:
        want, upd = enc.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = enc.apply(v, jnp.asarray(x))
    got = ours(t(x), train=train)
    assert got.shape == (2, hw[0] // 2, hw[1] // 2, 16)
    _close(got.detach(), want)
    if train:
        for n, w in flax_to_state_dict({"batch_stats": upd["batch_stats"]}).items():
            _close(ours.state_dict()[n], w, msg=n)


def test_convert_round_trips_a_spatial_encoder_tree():
    """convert maps every leaf of a flax SpatialEncoder tree (7x7 / 3x3 /
    1x1 conv kernels HWIO -> OIHW, BatchNorm scale, bias, mean, var) onto
    the port's module, names and shapes, and back."""
    enc = je.SpatialEncoder(je.SpatialEncoderConfig(**ENC))
    v = enc.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)))
    v = {"params": _redraw(v["params"], np.random.default_rng(3)),
         "batch_stats": _redraw(v["batch_stats"], np.random.default_rng(4))}
    sd = flax_to_state_dict(v)
    ours = te.SpatialEncoder(te.SpatialEncoderConfig(**ENC))
    assert set(sd) == set(ours.state_dict())
    ours.load_state_dict(sd)
    stem = np.asarray(v["params"]["stem"]["kernel"])
    np.testing.assert_array_equal(ours.stem.weight.detach().numpy(),
                                  stem.transpose(3, 2, 0, 1))
    bn = v["batch_stats"]["stage2_block0"]["BatchNorm_2"]
    np.testing.assert_array_equal(ours.stage2_block0.BatchNorm_2.running_var.numpy(),
                                  np.asarray(bn["var"]))
    back = {n: p.numpy() for n, p in ours.state_dict().items()}
    for path, leaf in jax.tree_util.tree_flatten_with_path(v["params"])[0]:
        keys = [p.key for p in path]
        if keys[-1] == "kernel":
            np.testing.assert_array_equal(
                back[".".join(keys[:-1] + ["weight"])].transpose(2, 3, 1, 0), leaf)


def test_bilinear_sample_2d_matches_jax():
    """align_corners=True with border clamping, uv inside and outside
    [-1, 1]."""
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((2, 6, 8, 5)).astype(np.float32)
    uv = rng.uniform(-1.4, 1.4, (2, 64, 2)).astype(np.float32)
    assert (np.abs(uv) > 1).any()
    _close(te.bilinear_sample_2d(t(feat), t(uv)),
           je.bilinear_sample_2d(jnp.asarray(feat), jnp.asarray(uv)))


# ----------------------------------------------------------------- resnetfc
@pytest.mark.parametrize("combine_type", ["average", "max"])
@pytest.mark.parametrize("num_views", [1, 2, 3])
def test_resnetfc_combine_matches_jax(num_views, combine_type):
    """ResnetFC with the multi-view combine at block 1 of 3: 5 points x
    num_views interleaved rows, latent injected before the combine only."""
    mlp = JaxResnetFC(d_out=7, n_blocks=3, d_latent=4, d_hidden=16, combine_layer=1,
                      combine_type=combine_type)
    x = np.random.default_rng(6).standard_normal((5 * num_views, 4 + 9)).astype(np.float32)
    v = mlp.init(jax.random.key(0), jnp.asarray(x), num_views=num_views)
    v = {"params": _redraw(v["params"], np.random.default_rng(7))}
    want, want_h = mlp.apply(v, jnp.asarray(x), num_views=num_views)
    ours = ResnetFC(d_in=9, d_out=7, n_blocks=3, d_latent=4, d_hidden=16, combine_layer=1,
                    combine_type=combine_type)
    ours.load_state_dict(flax_to_state_dict(v))
    got, got_h = ours(t(x), num_views=num_views)
    assert got.shape == (5, 7)
    _close(got.detach(), want)
    _close(got_h.detach(), want_h)


# ----------------------------------------------------------------- pixelnerf
def _query(rng, b=10):
    xyz = rng.uniform(-0.5, 0.5, (b, 3)).astype(np.float32)
    dirs = rng.standard_normal((b, 3)).astype(np.float32)
    return xyz, dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


@pytest.mark.parametrize("regress_coord", [False, True])
@pytest.mark.parametrize("ns", [1, 2])
def test_pixelnerf_matches_jax(ns, regress_coord):
    """PixelNerfNet.encode_and_query with ns source views: projection,
    latent lookup, code, viewdirs, view interleave and combine, heads."""
    jc, tc = _net_cfgs(regress_coord=regress_coord)
    jnet, v = _jax_net(jc)
    rng = np.random.default_rng(8)
    imgs, poses = _views(rng, ns)
    w2c = np.linalg.inv(poses).astype(np.float32)
    xyz, dirs = _query(rng)
    focal = np.asarray([FOCAL, -FOCAL], np.float32)
    c = np.asarray([0.5, -0.25], np.float32)
    query = jax.jit(lambda *a: jnet.apply(*a, method=jnet.encode_and_query))
    want = query(v, jnp.asarray(imgs * 2 - 1), jnp.asarray(w2c), jnp.asarray(focal),
                 jnp.asarray(c), jnp.asarray(xyz), jnp.asarray(dirs))
    got = _port_net(tc, v).encode_and_query(t(imgs * 2 - 1), t(w2c), t(focal), t(c), t(xyz),
                                            t(dirs))
    assert set(got) == set(want)
    for k in want:
        _close(got[k].detach(), want[k], msg=k)


def test_pixelnerf_aug_hooks_take_fed_noise(monkeypatch):
    """With use_input_aug / use_output_aug and train=True, the port's field
    fed JAX's noise draws (recorded from jax.random.normal) equals the JAX
    field; with train=False the hooks are the identity."""
    jc, tc = _net_cfgs(use_input_aug=True, use_output_aug=True, aug_noise_scale=0.05)
    jnet, v = _jax_net(jc)
    rng = np.random.default_rng(9)
    imgs, poses = _views(rng, 2)
    w2c = np.linalg.inv(poses).astype(np.float32)
    xyz, dirs = _query(rng)
    focal = np.asarray([FOCAL, -FOCAL], np.float32)
    drawn = []
    normal = jax.random.normal

    def record(key, shape=(), dtype=jnp.float32):
        n = normal(key, shape, dtype)
        drawn.append(np.asarray(n))
        return n

    latent = jnet.apply(v, jnp.asarray(imgs * 2 - 1), method=jnet.encode)
    args = (latent, jnp.asarray(w2c), jnp.asarray(focal), jnp.zeros(2), HW,
            jnp.asarray(xyz), jnp.asarray(dirs))
    monkeypatch.setattr(jax.random, "normal", record)
    want = jnet.apply(v, *args, train=True, rngs={"aug": jax.random.key(3)})
    want_off = jnet.apply(v, *args)
    monkeypatch.setattr(jax.random, "normal", normal)
    assert [d.shape for d in drawn] == [(10, 3), (10, 4 + 6)]
    net = _port_net(tc, v)
    targs = (net.encode(t(imgs * 2 - 1)), t(w2c), t(focal), torch.zeros(2), HW, t(xyz),
             t(dirs))
    got = net(*targs, train=True, aug_noise={"input": t(drawn[0]), "output": t(drawn[1])})
    got_off = net(*targs)
    for k in want:
        _close(got[k].detach(), want[k], msg=k)
        _close(got_off[k].detach(), want_off[k], msg=k)
    assert not np.allclose(np.asarray(want["rgb"]), np.asarray(want_off["rgb"]))


# ----------------------------------------------------------------- renderer
def _render_draws(key, r, rc):
    """JAX render_rays' draws for `key`: the split of its five keys."""
    k1, k2, k3, _, _ = jax.random.split(key, 5)
    k_u, k_j = jax.random.split(k2)
    nf = rc["n_fine"] - rc["n_fine_depth"]
    d = {"coarse_u": jax.random.uniform(k1, (r, rc["n_coarse"])),
         "fine_u": jax.random.uniform(k_u, (r, nf)),
         "fine_jitter": jax.random.uniform(k_j, (r, nf)),
         "fine_depth_eps": jax.random.normal(k3, (r, rc["n_fine_depth"]))}
    return {k: t(np.array(x)) for k, x in d.items()}


def _rays(poses, rng, r):
    from real_robot_nerf_actor_tpu_torch.ops.rays import gen_rays
    rays = gen_rays(t(poses), HW[1], HW[0], FOCAL, 1.0, 3.0).reshape(-1, 8)
    return rays[t(rng.choice(rays.shape[0], r, replace=False))].contiguous()


def test_render_rays_and_extract_radiance_match_jax():
    """Coarse + fine (importance and depth samples) with the coord head, 2
    source views, JAX's draws; extract_radiance's per-sample export."""
    jc, tc = _net_cfgs(regress_coord=True)
    jnet, v = _jax_net(jc)
    rng = np.random.default_rng(10)
    imgs, poses = _views(rng, 3)
    src = [0, 2]
    w2c = np.linalg.inv(poses[src]).astype(np.float32)
    focal = np.asarray([FOCAL, -FOCAL], np.float32)
    rays = _rays(poses[1:2], rng, 24)
    latent = jnet.apply(v, jnp.asarray(imgs[src] * 2 - 1), method=jnet.encode)
    jenc = (latent, jnp.asarray(w2c), jnp.asarray(focal), jnp.zeros(2), HW)
    jr = JaxRenderer(JaxRenderCfg(**RENDER), jnet)
    key = jax.random.key(11)
    want = jax.jit(lambda v, e, r, k: jr.render_rays(v, (*e, HW), r, k))(
        v, jenc[:4], jnp.asarray(rays.numpy()), key)
    net = _port_net(tc, v)
    tenc = (net.encode(t(imgs[src] * 2 - 1)), t(w2c), t(focal), torch.zeros(2), HW)
    rend = PixelNerfRenderer(PixelNerfRendererConfig(**RENDER), net)
    got = rend.render_rays(tenc, rays, draws=_render_draws(key, 24, RENDER))
    assert set(got) == {"coarse", "fine", "coarse_coord", "fine_coord"} == set(want)
    for level in ("coarse", "fine"):
        for field in ("rgb", "embed", "depth", "weights"):
            _close(getattr(got[level], field).detach(), getattr(want[level], field),
                   msg=f"{level}.{field}")
        _close(got[f"{level}_coord"].detach(), want[f"{level}_coord"], msg=level)
    want_x = jr.extract_radiance(v, jenc, jnp.asarray(rays.numpy()), key)
    u = t(np.array(jax.random.uniform(key, (24, RENDER["n_coarse"]))))
    got_x = rend.extract_radiance(tenc, rays, draws={"coarse_u": u})
    assert got_x["points"].shape == (24, 6, 3) and got_x["embed"].shape == (24, 6, 6)
    for k in want_x:
        _close(got_x[k].detach(), want_x[k], msg=k)


# ------------------------------------------------------------ trainer pieces
def test_sample_view_maps_and_attention_norm_loss_match_jax():
    rng = np.random.default_rng(12)
    maps = rng.standard_normal((3, 5, 7, 4)).astype(np.float32)
    v, y, x = (rng.integers(0, n, 64) for n in (3, 24, 36))
    want = jfn._sample_view_maps(jnp.asarray(maps), jnp.asarray(v), jnp.asarray(y),
                                 jnp.asarray(x), (24, 36))
    got = tfn._sample_view_maps(t(maps), t(v), t(y), t(x), (24, 36))
    _close(got, want)
    embed = rng.standard_normal((40, 16)).astype(np.float32)
    attn = rng.standard_normal((40, 6)).astype(np.float32)
    np.testing.assert_allclose(
        float(tfn.attention_norm_loss(t(embed), t(attn))),
        float(jfn.attention_norm_loss(jnp.asarray(embed), jnp.asarray(attn))), rtol=1e-5)


def _pixel_draws(key, r, nv, h, w):
    kv, ky, kx, kb = jax.random.split(key, 4)
    d = {"v": jax.random.randint(kv, (r,), 0, nv), "y": jax.random.randint(ky, (r,), 0, h),
         "x": jax.random.randint(kx, (r,), 0, w), "u_bbox": jax.random.uniform(kb, (r, 2))}
    return {k: t(np.array(a)) for k, a in d.items()}


@pytest.mark.parametrize("step", [0, 99, 100])
def test_bbox_switch_matches_jax(step):
    """Pixels inside each view's bbox while step < no_bbox_step, anywhere
    after; JAX's draws."""
    jc, tc = _net_cfgs()
    jcfg = jfn.FeatureNerfConfig(model=jc, ray_batch_size=64, no_bbox_step=100)
    tcfg = tfn.FeatureNerfConfig(model=tc, ray_batch_size=64, no_bbox_step=100)
    bbox = np.asarray([[2, 3, 9, 5], [0, 0, 15, 15], [4, 4, 4, 4]], np.int32)
    imgs = np.zeros((3, *HW, 3), np.float32)
    key = jax.random.key(13)
    want = jfn.FeatureNerfTrainer(jcfg)._sample_pixels(
        key, {"images": jnp.asarray(imgs), "bbox": jnp.asarray(bbox)}, jnp.asarray(step))
    got = tfn.FeatureNerfTrainer(tcfg, device="cpu")._sample_pixels(
        {"images": t(imgs), "bbox": t(bbox)}, step, draws=_pixel_draws(key, 64, 3, *HW))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    v, y, x = (a.numpy() for a in got)
    inside = (x >= bbox[v, 0]) & (x <= bbox[v, 2]) & (y >= bbox[v, 1]) & (y <= bbox[v, 3])
    assert inside.all() == (step < 100)


def _train_cfgs(**kw):
    jc, tc = _net_cfgs()
    common = dict(ray_batch_size=32, z_near=1.0, z_far=3.0, lambda_attn=0.1,
                  lambda_coord=0.25, no_bbox_step=100, **kw)
    jcfg = jfn.FeatureNerfConfig(model=jc, renderer=JaxRenderCfg(**RENDER),
                                 train=JaxTrainCfg(optim=JaxOptim(lr=1e-3)), **common)
    tcfg = tfn.FeatureNerfConfig(model=tc, renderer=PixelNerfRendererConfig(**RENDER),
                                 train=TrainConfig(optim=OptimConfig(lr=1e-3)), **common)
    return jcfg, tcfg


def _keep_grads():
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("mask_feat", [False, True])
def test_train_step_matches_jax(mask_feat):
    """One step with every loss on (rgb, embed, attn, coord; mask_feat on
    and off), 2 source views, bboxes: losses and metrics, every gradient,
    and the parameters after AdamW."""
    jcfg, tcfg = _train_cfgs(mask_feat=mask_feat)
    jtr = jfn.FeatureNerfTrainer(jcfg)
    jtr.tx = _keep_grads()
    _, v = _jax_net(jtr.cfg.model, seed=14)
    rng = np.random.default_rng(15)
    imgs, poses = _views(rng, 3)
    imgs[:, :4] = 1.0        # white background rows for mask_feat
    batch = {"images": imgs, "poses": poses, "focal": np.float32(FOCAL),
             "features": (0.1 * rng.standard_normal((3, 4, 4, 6))).astype(np.float32),
             "cls_attn": rng.uniform(0, 1, (3, 4, 4, 2)).astype(np.float32),
             "bbox": np.tile(np.asarray([[0, 0, 15, 9]], np.int32), (3, 1)),
             "src_ord": np.asarray([2, 0], np.int32)}
    state = JaxState(step=jnp.zeros((), jnp.int32), params=v["params"],
                     opt_state=jtr.tx.init(v["params"]),
                     extra={"batch_stats": v["batch_stats"]})
    key = jax.random.key(16)
    new, jm = jax.jit(jtr.train_step)(state, {k: jnp.asarray(a) for k, a in batch.items()},
                                      key)
    _, k_pix, k_render = jax.random.split(key, 3)

    tr = tfn.FeatureNerfTrainer(tcfg, device="cpu")
    st = tr.init_state(torch.Generator().manual_seed(0))
    st.module.load_state_dict(pixelnerf_to_state_dict(v["params"], v))
    st, m = tr.train_step(st, {k: torch.as_tensor(a) for k, a in batch.items()},
                          draws=_pixel_draws(k_pix, 32, 3, *HW),
                          render_draws=_render_draws(k_render, 32, RENDER))
    assert set(m) == set(jm) >= {"loss_rgb", "loss_embed", "loss_attn", "loss_coord"}
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
    want_g = flax_to_state_dict({"params": jax.device_get(new.opt_state)})
    named = dict(st.module.named_parameters())
    assert set(named) == set(want_g)
    for n, w in want_g.items():
        torch.testing.assert_close(named[n].grad, w, rtol=0,
                                   atol=1e-4 * w.abs().max().item() + 1e-30,
                                   msg=lambda s: f"{n}: {s}")
    assert named["encoder.stem.weight"].grad.abs().max() > 0
    tx = make_optimizer(jcfg.train.optim)
    upd, _ = tx.update(new.opt_state, tx.init(v["params"]), v["params"])
    want_p = flax_to_state_dict({"params": optax.apply_updates(v["params"], upd)})
    lr = jcfg.train.optim.lr
    moved = 0
    for n, w in want_p.items():
        gap = (named[n].detach() - w).abs()
        assert (gap <= 2 * lr * (1 + 1e-3) + 1e-6 * w.abs()).all(), n
        moved += int((gap > 1e-3 * lr + 1e-6 * w.abs()).sum())
    assert moved <= 1e-3 * sum(w.numel() for w in want_p.values())
    for n, b in st.module.named_buffers():   # encoding never moves the statistics
        torch.testing.assert_close(b, flax_to_state_dict(
            {"batch_stats": v["batch_stats"]})[n], rtol=0, atol=0)


def test_train_steps_follow_jax_through_adamw():
    """Two steps in a row from the JAX optimizer state after one (loaded by
    convert.load_optax_state): the port's second step lands where JAX's
    does."""
    jcfg, tcfg = _train_cfgs()
    jtr = jfn.FeatureNerfTrainer(jcfg)
    _, v = _jax_net(jtr.cfg.model, seed=17)
    rng = np.random.default_rng(18)
    imgs, poses = _views(rng, 3)
    batch = {"images": imgs, "poses": poses, "focal": np.float32(FOCAL),
             "features": (0.1 * rng.standard_normal((3, 4, 4, 6))).astype(np.float32),
             "src_ord": np.asarray([1], np.int32)}
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    state = JaxState(step=jnp.zeros((), jnp.int32), params=v["params"],
                     opt_state=jtr.tx.init(v["params"]),
                     extra={"batch_stats": v["batch_stats"]})
    step = jax.jit(jtr.train_step)
    s1, _ = step(state, jb, jax.random.key(1))
    s2, jm = step(s1, jb, jax.random.key(2))
    tr = tfn.FeatureNerfTrainer(tcfg, device="cpu")
    st = tr.init_state(torch.Generator().manual_seed(0))
    st.module.load_state_dict(pixelnerf_to_state_dict(s1.params, s1.extra))
    load_optax_state(st.optimizer, jax.device_get(s1.opt_state))
    st.step = 1
    _, k_pix, k_render = jax.random.split(jax.random.key(2), 3)
    st, m = tr.train_step(st, {k: torch.as_tensor(a) for k, a in batch.items()},
                          draws=_pixel_draws(k_pix, 32, 3, *HW),
                          render_draws=_render_draws(k_render, 32, RENDER))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    want = flax_to_state_dict({"params": s2.params})
    for n, p in st.module.named_parameters():
        torch.testing.assert_close(p.detach(), want[n], rtol=1e-6,
                                   atol=2e-5 * jcfg.train.optim.lr, msg=lambda s: f"{n}: {s}")


def _scene(rng, nv, attn_ndim):
    attn_shape = (nv, 2, 3, 3) if attn_ndim == 4 else (nv, 3, 3)
    return jsd.Scene(images=rng.uniform(0, 1, (nv, 8, 8, 3)).astype(np.float32),
                     poses=np.broadcast_to(np.eye(4, dtype=np.float32), (nv, 4, 4)).copy(),
                     focal=9.0, features=rng.standard_normal((nv, 3, 3, 6)).astype(np.float32),
                     cls_attn=rng.uniform(0, 1, attn_shape).astype(np.float32))


def test_scene_data_matches_jax():
    """The same scene and src_ord per step as JAX's numpy draws, and both
    cls_attn layouts staged NHWC: (N, heads, hf, wf) transposed, (N, hf,
    wf) with a channel axis."""
    rng = np.random.default_rng(19)
    scenes = [_scene(rng, 4, 4), _scene(rng, 5, 3)]
    jc, tc = _net_cfgs()
    jit = jfn.FeatureNerfTrainer(jfn.FeatureNerfConfig(model=jc, nviews=(1, 2, 3))).scene_data(
        scenes, seed=3)
    tit = tfn.FeatureNerfTrainer(tfn.FeatureNerfConfig(model=tc, nviews=(1, 2, 3)),
                                 device="cpu").scene_data(scenes, seed=3)
    seen = set()
    for _ in range(12):
        want, got = next(jit), next(tit)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        seen.add((got["images"].shape[0], got["src_ord"].shape[0]))
    assert {nv for nv, _ in seen} == {4, 5} and {ns for _, ns in seen} == {1, 2, 3}


def test_scene_npz_read_by_either_package(tmp_path):
    """synthesize_scene_npz writes the JAX package's file, and each package
    reads the other's."""
    tsd.synthesize_scene_npz(str(tmp_path / "t.npz"), n_views=3, hw=(12, 16), seed=2,
                             d_feature=5)
    jsd.synthesize_scene_npz(str(tmp_path / "j.npz"), n_views=3, hw=(12, 16), seed=2,
                             d_feature=5)
    ours, theirs = jsd.load_scene(str(tmp_path / "t.npz")), tsd.load_scene(str(tmp_path / "j.npz"))
    for f in ("images", "poses", "features"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f), err_msg=f)
    assert ours.focal == theirs.focal and ours.images.max() > 0
    for split in ("train", "val"):
        assert tsd.SceneDataset(str(tmp_path), split).paths == \
            jsd.SceneDataset(str(tmp_path), split).paths


# ----------------------------------------------------------------------- eval
def test_ssim_correspondence_and_extract_match_jax():
    rng = np.random.default_rng(20)
    a = rng.uniform(0, 1, (20, 24, 3))
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1)
    assert ssim_np(a, b) == jax_ssim(a, b) and ssim_np(a[..., 0], b[..., 0]) == jax_ssim(
        a[..., 0], b[..., 0])
    fa, fb = rng.standard_normal((6, 7, 5)), rng.standard_normal((5, 8, 5))
    q = np.stack([rng.integers(0, 6, 9), rng.integers(0, 7, 9)], -1)
    for x, y in zip(tcorr.find_correspondences(fa, fb, q), jcorr.find_correspondences(fa, fb, q)):
        np.testing.assert_array_equal(x, y)
    assert tcorr.cycle_consistency(fa, fb, q) == jcorr.cycle_consistency(fa, fb, q)
    sig = rng.exponential(1.0, 5000)
    for lo, hi in [(1000, 2000), (6000, 7000)]:
        assert text.sigma_threshold_search(sig, lo, hi) == jext.sigma_threshold_search(sig, lo, hi)
    pts, rgb = rng.standard_normal((5000, 3)), rng.uniform(0, 1, (5000, 3))
    emb, base = rng.standard_normal((5000, 4)), np.eye(4)
    base[:3, 3] = [0.1, 0.2, 0.3]
    got = text.extract_nerf_pointcloud(pts, rgb, sig, emb, base, target_min=500, target_max=900)
    want = jext.extract_nerf_pointcloud(pts, rgb, sig, emb, base, target_min=500,
                                        target_max=900)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    grid = text.sample_sigma_grid(lambda p: np.linalg.norm(p, axis=-1), np.asarray(
        [-1, -1, -1, 1, 1, 1.0]), resolution=9, chunk=100)
    np.testing.assert_array_equal(grid, jext.sample_sigma_grid(
        lambda p: np.linalg.norm(p, axis=-1), np.asarray([-1, -1, -1, 1, 1, 1.0]), 9, 100))
    import builtins
    real_import = builtins.__import__

    def no_skimage(name, *args, **kw):
        if name.startswith("skimage"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    builtins.__import__ = no_skimage
    try:   # the fallback of both packages: vertices only
        vt, ft = text.extract_mesh(grid, 0.8, origin=(1, 2, 3), spacing=(0.5, 0.5, 0.5))
        vj, fj = jext.extract_mesh(grid, 0.8, origin=(1, 2, 3), spacing=(0.5, 0.5, 0.5))
    finally:
        builtins.__import__ = real_import
    assert ft is None and fj is None and len(vt) > 0
    np.testing.assert_array_equal(vt, vj)


def test_depth_correspondence_scores_matches():
    """A frame matched into itself (one view, constant depth) with
    embeddings that name each pixel scores 1; shifted embeddings score 0."""
    h = w = 8
    emb = np.eye(h * w, dtype=np.float32).reshape(h, w, h * w)
    sc = tsd.Scene(images=np.zeros((1, h, w, 3), np.float32),
                   poses=np.eye(4, dtype=np.float32)[None], focal=10.0,
                   depth=np.full((1, h, w), 2.0, np.float32))
    rng = np.random.default_rng(0)
    got = novel.depth_correspondence(emb, emb, sc, 0, 0, 40, 0.5, rng)
    assert got["corr_acc"] == 1.0 and got["corr_queries"] == 40
    shifted = np.roll(emb, 3, axis=1)
    assert novel.depth_correspondence(emb, shifted, sc, 0, 0, 40, 0.5, rng)["corr_acc"] == 0.0


# ------------------------------------------------------------------------ CLI
TINY_OVERRIDES = ["model.d_embed=6", "model.d_hidden=16", "model.n_blocks=2",
                  "model.combine_layer=1",
                  'model.encoder={"stage_features": [4, 4, 8], "blocks_per_stage": 1}',
                  "renderer.n_coarse=6", "renderer.n_fine=4", "renderer.n_fine_depth=2",
                  "ray_batch_size=16", "lambda_coord=0.25", "nviews=[1, 2]",
                  "train.log_every=1", "train.ckpt_every=2", "train.prefetch=0"]


def _plane_depth(poses, h, w, f, z0):
    """z-depth of the world plane z = z0 in each view, in the eval's pixel
    convention (c = ((w - 1) / 2, (h - 1) / 2))."""
    ys, xs = np.mgrid[0:h, 0:w]
    d = np.stack([(xs - (w - 1) / 2) / f, -(ys - (h - 1) / 2) / f, -np.ones((h, w))], -1)
    dz = np.einsum("nj,hwj->nhw", poses[:, 2, :3], d)
    return ((z0 - poses[:, 2, 3])[:, None, None] / dz).astype(np.float32)


def test_cli_trains_resumes_and_evaluates(tmp_path):
    """featurenerf.main for 2 steps, then again to 3 (resumed from the
    checkpoint of step 2), then eval/novel.py's main on that checkpoint
    over a scene with depth (views 45 degrees apart see a ground plane:
    correspondence on)."""
    root = tmp_path / "scenes"
    root.mkdir()
    for i in range(2):
        sc = tsd.synthesize_scene_npz(str(root / f"scene_{i}.npz"), n_views=24, hw=(12, 16),
                                      seed=i, d_feature=6)
    sc.depth = _plane_depth(sc.poses, 12, 16, sc.focal, z0=0.1)
    tsd.save_scene(str(root / "scene_1.npz"), sc)
    ck = str(tmp_path / "ckpt")
    base = ["--device", "cpu", "--data-root", str(root), "--ckpt-dir", ck]
    for o in TINY_OVERRIDES:
        base += ["-o", o]
    st = tfn.main(base + ["--steps", "2"])
    assert st.step == 2
    from real_robot_nerf_actor_tpu_torch.train.trainer import CheckpointManager
    assert CheckpointManager(ck).all_steps() == [2]
    st = tfn.main(base + ["--steps", "3"])
    assert st.step == 3 and CheckpointManager(ck).all_steps() == [2, 3]
    out_json = str(tmp_path / "eval.json")
    res = novel.main(["--device", "cpu", "--data-root", str(root), "--ckpt-dir", ck,
                      "--n-scenes", "2", "--n-corr", "192", "--out-json", out_json,
                      "--out", str(tmp_path / "panels")]
                     + [a for o in TINY_OVERRIDES for a in ("-o", o)])
    assert res["step"] == 3 and len(res["scenes"]) == 2
    assert np.isfinite(res["psnr_mean"]) and -1 <= res["ssim_mean"] <= 1
    assert "corr_acc" not in res["scenes"][0] and 0 <= res["scenes"][1]["corr_acc"] <= 1
    assert len(res["scenes"][1]["frame_ms"]) == 2
    assert sorted(p.name for p in (tmp_path / "panels").iterdir()) == [
        "novel_0.png", "novel_1.png"]
    import json
    assert json.load(open(out_json))["psnr_mean"] == res["psnr_mean"]
