"""The representation zoo of the PyTorch port against the JAX package, at a
tiny size (32 x 32 images, batch 2; clouds of a few hundred points; a CLIP
tower of one bottleneck a stage at 64 x 64): the JAX module's variables
(BatchNorm statistics and scales redrawn with numpy, so they matter) go
through convert.flax_to_state_dict into the port's module, or a
torch-checkpoint converter of each package takes the same torch-layout
state_dict; the inputs come from numpy seeds.

Tolerances (fp32): forwards within 1e-5 of the output's largest |value|;
sampler indices equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.models import clip_visual as jclip
from real_robot_nerf_actor_tpu.models import pointnet2 as jpn2
from real_robot_nerf_actor_tpu.models import representations as jrep
from real_robot_nerf_actor_tpu.models import resnet as jres
from real_robot_nerf_actor_tpu.models.encoder2d import SpatialEncoderConfig as JaxEncCfg
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict, pixelnerf_to_state_dict
from real_robot_nerf_actor_tpu_torch.models import clip_visual as tclip
from real_robot_nerf_actor_tpu_torch.models import pointnet2 as tpn2
from real_robot_nerf_actor_tpu_torch.models import representations as trep
from real_robot_nerf_actor_tpu_torch.models import resnet as tres
from real_robot_nerf_actor_tpu_torch.models.encoder2d import SpatialEncoderConfig
from test_clip_visual import TINY as CLIP_TINY
from test_clip_visual import _random_sd as clip_state_dict
from test_resnet_zoo import _random_state_dict as torchvision_state_dict

t = torch.from_numpy
ENC = dict(stage_features=(4, 4, 8), blocks_per_stage=1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The sizes are tiny: one torch thread a test, so that the suite's
    parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=1e-5, msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max() + 1e-30,
                               err_msg=msg)


def redraw_norms(variables, rng):
    """BatchNorm / LayerNorm leaves redrawn with numpy: scales U(0.5, 1.5),
    biases and running means N(0, 0.1^2), variances U(0.5, 1.5); every
    other leaf kept."""
    def draw(path, a):
        keys = [getattr(p, "key", "") for p in path]
        name, s = keys[-1], np.shape(a)
        norm = any(k.startswith(("bn", "down_bn", "BatchNorm", "LayerNorm", "norm"))
                   for k in keys[-2:-1])
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, s), jnp.float32)
        if name == "mean":
            return jnp.asarray(0.1 * rng.standard_normal(s), jnp.float32)
        if norm and name == "scale":
            return jnp.asarray(rng.uniform(0.5, 1.5, s), jnp.float32)
        if norm and name == "bias":
            return jnp.asarray(0.1 * rng.standard_normal(s), jnp.float32)
        return a
    return jax.tree_util.tree_map_with_path(draw, variables)


def jax_variables(module, *args, seed=0):
    v = module.init(jax.random.key(seed), *args)
    return redraw_norms(jax.tree_util.tree_map(np.asarray, v), np.random.default_rng(seed))


def load(module, variables):
    module.load_state_dict(flax_to_state_dict(variables))
    return module.eval()


def images(n=2, hw=(32, 32), seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (n, *hw, 3)).astype(np.float32)


def cloud(n=2, pts=400, ch=6, seed=2):
    return np.random.default_rng(seed).uniform(0, 1, (n, pts, ch)).astype(np.float32)


# ------------------------------------------------------------------ ResNet
@pytest.mark.parametrize("spec", ["RESNET18", "RESNET34", "RESNET50"])
@pytest.mark.parametrize("spatial", [False, True])
def test_resnet_matches_jax(spec, spatial):
    """TorchvisionResNet on running statistics, pooled and spatial."""
    x = images()
    jnet = jres.TorchvisionResNet(getattr(jres, spec))
    v = jax_variables(jnet, jnp.asarray(x))
    tnet = load(tres.TorchvisionResNet(getattr(tres, spec)), v)
    _close(tnet(t(x), spatial=spatial), jnet.apply(v, jnp.asarray(x), spatial=spatial))


def test_resnet_train_mode_matches_jax():
    """ResNet-18 on batch statistics (64 x 64, batch 4: layer4's BatchNorm
    sees 16 values a channel), the running update at momentum 0.9: the
    statistics within 1e-5 of their scale, the output within 1e-4. Both
    packages take flax's fast variance E[x^2] - E[x]^2, whose fp32 rounding
    grows through each normalisation: the output read 2.5e-5 here."""
    x = images(n=4, hw=(64, 64))
    jnet = jres.TorchvisionResNet(jres.RESNET18)
    v = jax_variables(jnet, jnp.asarray(x))
    tnet = load(tres.TorchvisionResNet(tres.RESNET18), v)
    want, upd = jnet.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = tnet(t(x), train=True)
    sd = tnet.state_dict()
    for n, a in flax_to_state_dict({"batch_stats": upd["batch_stats"]}).items():
        _close(sd[n], a.numpy(), msg=n)
    _close(got, want, tol=1e-4)


@pytest.mark.parametrize("spec", ["RESNET18", "RESNET50"])
@pytest.mark.parametrize("prefix", ["", "module.encoder_q."])
def test_torch_resnet_checkpoint_converters(spec, prefix):
    """convert_torch_resnet_weights (and convert_mocov2_weights, whose keys
    carry MoCo's prefix and an MLP head to drop) of the same torchvision-
    layout state_dict give the JAX converter's features."""
    sd = torchvision_state_dict(getattr(jres, spec), np.random.default_rng(0))
    x = images()
    if prefix:
        sd = {prefix + k: v for k, v in sd.items()}
        sd[prefix + "fc.0.weight"] = torch.zeros(3, 3)
        sd["module.encoder_k.conv1.weight"] = torch.zeros(1)
        jv = jres.convert_mocov2_weights(sd, getattr(jres, spec))
        tsd = tres.convert_mocov2_weights(sd, getattr(tres, spec))
    else:
        jv = jres.convert_torch_resnet_weights(sd, getattr(jres, spec))
        tsd = tres.convert_torch_resnet_weights(sd, getattr(tres, spec))
    want = jres.TorchvisionResNet(getattr(jres, spec)).apply(jv, jnp.asarray(x))
    tnet = tres.TorchvisionResNet(getattr(tres, spec))
    tnet.load_state_dict(tsd)
    _close(tnet(t(x)), want)


# -------------------------------------------------------------- PointNet++
@pytest.mark.parametrize("n,npoint", [(300, 64), (513, 128)])
def test_farthest_point_sample_matches_jax(n, npoint):
    xyz = np.random.default_rng(n).uniform(-1, 1, (3, n, 3)).astype(np.float32)
    want = np.asarray(jpn2.farthest_point_sample(jnp.asarray(xyz), npoint))
    np.testing.assert_array_equal(tpn2.farthest_point_sample(t(xyz), npoint).numpy(), want)


@pytest.mark.parametrize("radius,nsample", [(0.2, 32), (0.4, 64), (0.05, 8)])
def test_ball_query_matches_jax(radius, nsample):
    """First hits in index order, misses padded with the first hit (r 0.05
    leaves most groups short; the centre itself is a point, so every group
    has a hit)."""
    xyz = np.random.default_rng(7).uniform(0, 1, (2, 400, 3)).astype(np.float32)
    centers = xyz[:, ::10]
    want = np.asarray(jpn2.ball_query(jnp.asarray(xyz), jnp.asarray(centers), radius, nsample))
    got = tpn2.ball_query(t(xyz), t(centers), radius, nsample)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ch", [3, 6])
def test_pointnet2_matches_jax(ch):
    pts = cloud(ch=ch)
    jnet = jpn2.PointNet2Encoder()
    v = jax_variables(jnet, jnp.asarray(pts))
    tnet = load(tpn2.PointNet2Encoder(ch), v)
    _close(tnet(t(pts)), jnet.apply(v, jnp.asarray(pts)))


def test_torch_pointnet2_checkpoint_converter():
    """The reference's pointnet2_cls layout (1x1 Conv2d + BatchNorm2d per
    layer, an fc head) through both packages' converters."""
    rng = np.random.default_rng(4)
    chans = {"sa1": [6, 64, 64, 128], "sa2": [131, 128, 128, 256], "sa3": [259, 256, 512, 1024]}
    sd = {"fc1.weight": torch.zeros(2, 2)}
    for sa, cs in chans.items():
        for j in range(3):
            c = cs[j + 1]
            sd[f"{sa}.mlp_convs.{j}.weight"] = t(
                (rng.standard_normal((c, cs[j], 1, 1)) / np.sqrt(cs[j])).astype(np.float32))
            sd[f"{sa}.mlp_convs.{j}.bias"] = t(0.1 * rng.standard_normal(c).astype(np.float32))
            for leaf, val in (("weight", rng.uniform(0.5, 1.5, c)),
                              ("bias", 0.1 * rng.standard_normal(c)),
                              ("running_mean", 0.1 * rng.standard_normal(c)),
                              ("running_var", rng.uniform(0.5, 1.5, c))):
                sd[f"{sa}.mlp_bns.{j}.{leaf}"] = t(val.astype(np.float32))
    pts = cloud()
    want = jpn2.PointNet2Encoder().apply(jpn2.convert_torch_pointnet2_weights(sd),
                                         jnp.asarray(pts))
    tnet = tpn2.PointNet2Encoder(6)
    tnet.load_state_dict(tpn2.convert_torch_pointnet2_weights(sd))
    _close(tnet(t(pts)), want)


# --------------------------------------------------------------- CLIP visual
@pytest.mark.parametrize("pool", [False, True])
def test_clip_visual_matches_jax(pool):
    """ClipVisualResNet's prepool map and attention-pooled embedding, on
    the JAX variables and on an OpenAI-layout state_dict through both
    converters."""
    cfg = CLIP_TINY
    tcfg = tclip.ClipVisualConfig(layers=cfg.layers, width=cfg.width,
                                  output_dim=cfg.output_dim, heads=cfg.heads,
                                  input_resolution=cfg.input_resolution)
    hw = (cfg.input_resolution, cfg.input_resolution)
    x = images(hw=hw) * 2 - 1
    jnet = jclip.ClipVisualResNet(cfg)
    v = jax_variables(jnet, jnp.asarray(x), True)
    _close(load(tclip.ClipVisualResNet(tcfg), v)(t(x), pool=pool),
           jnet.apply(v, jnp.asarray(x), pool=pool))
    sd = {"visual." + k: val for k, val in clip_state_dict(cfg, np.random.default_rng(3)).items()}
    sd["transformer.resblocks.0.ln_1.weight"] = torch.zeros(1)
    tnet = tclip.ClipVisualResNet(tcfg)
    tnet.load_state_dict(tclip.convert_clip_visual_weights(sd, tcfg))
    _close(tnet(t(x), pool=pool),
           jnet.apply(jclip.convert_clip_visual_weights(sd, cfg), jnp.asarray(x), pool=pool))


def test_extract_clip_features_matches_jax():
    from real_robot_nerf_actor_tpu.train.distill2d import extract_clip_features as jax_extract
    from real_robot_nerf_actor_tpu_torch.train.distill2d import extract_clip_features
    cfg = CLIP_TINY
    sd = clip_state_dict(cfg, np.random.default_rng(5))
    tcfg = tclip.ClipVisualConfig(layers=cfg.layers, width=cfg.width, output_dim=cfg.output_dim,
                                  heads=cfg.heads, input_resolution=cfg.input_resolution)
    tnet = tclip.ClipVisualResNet(tcfg)
    tnet.load_state_dict(tclip.convert_clip_visual_weights(sd, tcfg))
    x = images(n=3, hw=(64, 96))
    got = extract_clip_features(tnet, x)
    want = jax_extract(jclip.convert_clip_visual_weights(sd, cfg), x, cfg)
    assert got.shape == (3, 2, 3, cfg.feat_dim) and got.dtype == np.float32
    _close(got, want)


# ---------------------------------------------------------------- the zoo
def _obs(name):
    if name in ("pointnet", "pointnet2"):
        return cloud()
    if name in ("pointnerf", "fusion"):
        c = cloud(ch=6)
        return {"image": images(hw=(16, 16)), "points": c[..., :3], "colors": c[..., 3:]}
    if name == "state":
        return np.random.default_rng(3).standard_normal((2, 7)).astype(np.float32)
    return images()


ZOO = ["zero", "state", "simple", "resnet18", "resnet34", "resnet50", "imgnet", "mocov2",
       "pri3d", "pixelnerf", "featurenerf", "dino", "mvp", "pointnet", "pointnet2",
       "pointnerf", "fusion"]


def _featurenerf_variables():
    """featurenerf_encoder_variables of a JAX FeatureNerfTrainer state (its
    BatchNorm statistics redrawn), and of the port's trainer state after
    that state's conversion (convert.pixelnerf_to_state_dict)."""
    from real_robot_nerf_actor_tpu.models.pixelnerf import PixelNerfConfig as JaxNetCfg
    from real_robot_nerf_actor_tpu.train import featurenerf as jfn
    from real_robot_nerf_actor_tpu_torch.models.pixelnerf import PixelNerfConfig
    from real_robot_nerf_actor_tpu_torch.train import featurenerf as tfn
    net = dict(d_embed=6, d_hidden=16, n_blocks=2, combine_layer=1)
    jtr = jfn.FeatureNerfTrainer(jfn.FeatureNerfConfig(
        model=JaxNetCfg(encoder=JaxEncCfg(**ENC), **net)))
    state = jtr.init_state(jax.random.key(0), image_shape=(16, 16))
    state = state.replace(extra=redraw_norms(jax.tree_util.tree_map(np.asarray, state.extra),
                                             np.random.default_rng(1)))
    ttr = tfn.FeatureNerfTrainer(tfn.FeatureNerfConfig(
        model=PixelNerfConfig(encoder=SpatialEncoderConfig(**ENC), **net)), device="cpu")
    tstate = ttr.init_state(torch.Generator().manual_seed(0))
    tstate.module.load_state_dict(pixelnerf_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params), state.extra))
    return jrep.featurenerf_encoder_variables(state), trep.featurenerf_encoder_variables(tstate)


def _mae_checkpoint():
    """An MAE-layout ViT-B/16 checkpoint: a "model" wrapper, timm names,
    decoder keys and a mask token to drop, fc_norm for the final norm."""
    rng = np.random.default_rng(6)
    ck = {}
    for k, v in trep.DinoCLS(trep.MVP_VIT_CFG).vit.state_dict().items():
        k = (k.replace("block_", "blocks.").replace(".fc1", ".mlp.fc1")
             .replace(".fc2", ".mlp.fc2").replace("patch_embed.", "patch_embed.proj."))
        if k.startswith("norm."):
            k = "fc_norm." + k[len("norm."):]
        base = 1.0 if k.endswith(("norm1.weight", "norm2.weight", "fc_norm.weight")) else 0.0
        scale = 0.02 if v.dim() >= 2 else 0.1
        ck[k] = (base + scale * rng.standard_normal(tuple(v.shape))).astype(np.float32)
    return {"model": {**ck, "decoder_embed.weight": np.zeros((2, 2), np.float32),
                      "mask_token": np.zeros((1, 1, 768), np.float32)}}


@pytest.mark.parametrize("name", ZOO)
def test_make_embedding_matches_jax(name):
    """Every zoo name: the same out_dim and the same features. The weights:
    the JAX entry's init (norms redrawn) through convert.flax_to_state_dict;
    for mvp, an MAE checkpoint through each package's mvp_encoder_variables;
    for featurenerf, each package's featurenerf_encoder_variables of the
    same trained state (pixelnerf / featurenerf on a small encoder)."""
    obs = _obs(name)
    enc = {"encoder_cfg": JaxEncCfg(**ENC)} if name in ("pixelnerf", "featurenerf") else {}
    tenc = {"encoder_cfg": SpatialEncoderConfig(**ENC)} if enc else {}
    jemb = jrep.make_embedding(name, **enc)
    temb = trep.make_embedding(name, **tenc)
    assert temb.out_dim == jemb.out_dim
    jobs = jax.tree_util.tree_map(jnp.asarray, obs)
    if name == "mvp":
        ck = _mae_checkpoint()
        v, sd = jrep.mvp_encoder_variables(ck), trep.mvp_encoder_variables(ck)
    elif name == "featurenerf":
        v, sd = _featurenerf_variables()
    else:
        v = jemb.init(jax.random.key(0), jobs)
        if v:
            v = redraw_norms(jax.tree_util.tree_map(np.asarray, v), np.random.default_rng(0))
        sd = flax_to_state_dict(v)
    want = jemb(v, jobs)
    if temb.build is not None:   # the weights come from JAX: built, not drawn
        temb.module = temb.build(obs)
        temb.module.load_state_dict(sd)
    with torch.no_grad():
        got = temb(obs)
    _close(got, want)


@pytest.mark.parametrize("name", ["zero", "simple", "pointnet", "fusion"])
def test_probe_out_dim_matches_jax(name):
    obs = _obs(name)
    jobs = jax.tree_util.tree_map(jnp.asarray, obs)
    assert trep.probe_out_dim(trep.make_embedding(name), obs) == jrep.probe_out_dim(
        jrep.make_embedding(name), jobs)


def test_zoo_names_draw_distinct_weights():
    """Names that share an architecture (resnet50 / imgnet / mocov2 / pri3d,
    pixelnerf / featurenerf, pointnerf / fusion) draw their own weights
    (the seed with crc32(name)); the same name and seed the same ones."""
    seeds = {n: trep.name_seed(0, n) for n in ("resnet50", "imgnet", "mocov2", "pri3d")}
    assert len(set(seeds.values())) == 4 and trep.name_seed(1, "pri3d") != seeds["pri3d"]
    enc = {"encoder_cfg": SpatialEncoderConfig(**ENC)}
    for names, obs, kw in ((("pixelnerf", "featurenerf"), images(n=1), enc),
                           (("pointnerf", "fusion"), _obs("fusion"), {})):
        feats = []
        for name in names + names[:1]:
            emb = trep.make_embedding(name, **kw)
            emb.init(obs, seed=0, device="cpu")
            with torch.no_grad():
                feats.append(emb(obs).numpy())
        np.testing.assert_array_equal(feats[0], feats[2])
        assert np.abs(feats[0] - feats[1]).max() > 1e-4, names


def test_make_embedding_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown embedding"):
        trep.make_embedding("resnet101")
