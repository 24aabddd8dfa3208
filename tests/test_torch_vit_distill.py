"""The DINO ViT teacher, its converters, PCA, the 2-D student and the
teacher-feature dumper of the PyTorch port against the JAX package, at a
tiny size (ViT depth 2, width 32-48, patch 8): the same weights (JAX's
trees redrawn with numpy, or a synthesized DINO torch-layout checkpoint
converted by both packages) and the same inputs from numpy seeds.

Tolerances (fp32): forwards 1e-5 of the output's largest |value|; PCA
projections 1e-5 of their scale on a spectrum with clear gaps; the
student's train step: loss 1e-5 relative, gradients 1e-4 of each tensor's
largest |g|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from real_robot_nerf_actor_tpu.models import vit as jvit
from real_robot_nerf_actor_tpu.train import distill2d as jd
from real_robot_nerf_actor_tpu.train.trainer import OptimConfig as JaxOptim
from real_robot_nerf_actor_tpu.train.trainer import TrainConfig as JaxTrainCfg
from real_robot_nerf_actor_tpu.train.trainer import TrainState as JaxState
from real_robot_nerf_actor_tpu.utils import pca as jpca
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
from real_robot_nerf_actor_tpu_torch.data import scene_dataset as tsd
from real_robot_nerf_actor_tpu_torch.models import vit as tvit
from real_robot_nerf_actor_tpu_torch.ops.resize import resize
from real_robot_nerf_actor_tpu_torch.train import distill2d as td
from real_robot_nerf_actor_tpu_torch.train.trainer import OptimConfig, TrainConfig
from real_robot_nerf_actor_tpu_torch.utils import pca as tpca

t = torch.from_numpy
VIT = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2)


def _close(got, want, tol=1e-5, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max() + 1e-30, err_msg=msg)


def _redraw(tree, rng):
    """Kernels N(0, 1 / fan_in), LayerNorm scales 1 + N(0, 0.1^2), the
    positional table and CLS token N(0, 0.5^2), other vectors N(0, 0.1^2)."""
    def draw(path, a):
        name, s = path[-1].key, np.shape(a)
        if name in ("pos_embed", "cls_token"):
            x = 0.5 * rng.standard_normal(s)
        elif len(s) >= 2:
            x = rng.standard_normal(s) / np.sqrt(np.prod(s[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(s)
        else:
            x = 0.1 * rng.standard_normal(s)
        return jnp.asarray(x, jnp.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


def _vits(image_size, hw, seed=0, **kw):
    cfg = dict(VIT, image_size=image_size, **kw)
    jv = jvit.DinoViT(jvit.ViTConfig(**cfg))
    v = jv.init(jax.random.key(0), jnp.zeros((1, *hw, 3)))
    v = {"params": _redraw(v["params"], np.random.default_rng(seed))}
    ours = tvit.DinoViT(tvit.ViTConfig(**cfg))
    ours.load_state_dict(flax_to_state_dict(v))
    return jv, v, ours


@pytest.mark.parametrize("hw,image_size", [((32, 32), 32), ((60, 80), 80)])
def test_dino_vit_matches_jax(hw, image_size):
    """Depth 2: the final tokens and every per-layer output. (32, 32) at
    its native grid; (60, 80) at image_size 80 pads its rows to 8 patches
    ("SAME") and resizes the 10 x 10 positional grid to 8 x 10 (bicubic,
    antialiased along the shrinking axis)."""
    jv, v, ours = _vits(image_size, hw)
    x = np.random.default_rng(1).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jv.apply(v, x, layers_to_return=(0, 1)))(v, jnp.asarray(x))
    got = ours(t(x), layers_to_return=(0, 1))
    assert got["grid"] == tuple(want["grid"]) == ((hw[0] + 7) // 8, (hw[1] + 7) // 8)
    _close(got["tokens"].detach(), want["tokens"])
    for layer in (0, 1):
        for k in ("tokens", "q", "k", "v", "attn"):
            _close(got["layers"][layer][k].detach(), want["layers"][layer][k],
                   msg=f"{layer}.{k}")


@pytest.mark.parametrize("spot", ["gelu", "layernorm_eps", "bicubic"])
def test_vit_trouble_spots_are_seen_by_the_tolerance(spot):
    """Each of flax's definitions the port keeps differs from torch's
    default by more than the forward tolerance on the ViT's inputs: gelu
    (tanh against erf), LayerNorm epsilon (1e-6 against 1e-5, on a
    low-variance row) and the positional resize (jax.image.resize bicubic
    against F.interpolate's)."""
    rng = np.random.default_rng(2)
    if spot == "gelu":
        x = np.linspace(-3, 3, 1001, dtype=np.float32)
        want = fnn.gelu(jnp.asarray(x))
        ours = F.gelu(t(x), approximate="tanh")
        other = F.gelu(t(x))
    elif spot == "layernorm_eps":
        x = (1e-3 * rng.standard_normal((4, 32))).astype(np.float32)
        ln = fnn.LayerNorm()
        want = ln.apply(ln.init(jax.random.key(0), jnp.asarray(x)), jnp.asarray(x))
        ours = torch.nn.LayerNorm(32, eps=1e-6)(t(x)).detach()
        other = torch.nn.LayerNorm(32)(t(x)).detach()
    else:
        x = rng.standard_normal((1, 10, 10, 32)).astype(np.float32)
        want = jax.image.resize(jnp.asarray(x), (1, 8, 10, 32), method="bicubic")
        ours = resize(t(x), (8, 10), "bicubic")
        other = F.interpolate(t(x).permute(0, 3, 1, 2), size=(8, 10), mode="bicubic",
                              align_corners=False).permute(0, 2, 3, 1)
    _close(ours, want)
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(other.numpy() - np.asarray(want)).max() > 10 * 1e-5 * scale


def test_extract_dense_features_matches_jax():
    """Layer-1 keys as (B, gh, gw, D) features, layer-1 CLS attention as
    (B, heads, gh, gw), on the 60 x 80 branch."""
    jv, v, ours = _vits(80, (60, 80), seed=3)
    x = np.random.default_rng(4).uniform(0, 1, (2, 60, 80, 3)).astype(np.float32)
    wf, wa = jvit.extract_dense_features(jv, v, jnp.asarray(x), 1, 1)
    gf, ga = tvit.extract_dense_features(ours, t(x), 1, 1)
    assert gf.shape == (2, 8, 10, 32) and ga.shape == (2, 2, 8, 10)
    _close(gf.detach(), wf)
    _close(ga.detach(), wa)


def _dino_state_dict(cfg, rng):
    """A DINO checkpoint in timm's torch layout, drawn with numpy."""
    d, p, hid = cfg["embed_dim"], cfg["patch_size"], 4 * cfg["embed_dim"]
    n = (cfg["image_size"] // p) ** 2 + 1

    def r(*s, scale=None):
        scale = scale if scale is not None else 1 / np.sqrt(s[-1] if len(s) > 1 else 10)
        return (scale * rng.standard_normal(s)).astype(np.float32)

    sd = {"patch_embed.proj.weight": r(d, 3, p, p, scale=1 / np.sqrt(3 * p * p)),
          "patch_embed.proj.bias": r(d, scale=0.1), "cls_token": r(1, 1, d, scale=0.5),
          "pos_embed": r(1, n, d, scale=0.5), "norm.weight": 1 + r(d, scale=0.1),
          "norm.bias": r(d, scale=0.1)}
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        sd.update({b + "norm1.weight": 1 + r(d, scale=0.1), b + "norm1.bias": r(d, scale=0.1),
                   b + "attn.qkv.weight": r(3 * d, d), b + "attn.qkv.bias": r(3 * d, scale=0.1),
                   b + "attn.proj.weight": r(d, d), b + "attn.proj.bias": r(d, scale=0.1),
                   b + "norm2.weight": 1 + r(d, scale=0.1), b + "norm2.bias": r(d, scale=0.1),
                   b + "mlp.fc1.weight": r(hid, d), b + "mlp.fc1.bias": r(hid, scale=0.1),
                   b + "mlp.fc2.weight": r(d, hid), b + "mlp.fc2.bias": r(d, scale=0.1)})
    return sd


def test_convert_torch_dino_weights_matches_jax():
    """A synthesized DINO checkpoint through both packages' converters:
    the same forward."""
    cfg = dict(VIT, image_size=32)
    sd = _dino_state_dict(cfg, np.random.default_rng(5))
    x = np.random.default_rng(6).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jv = jvit.DinoViT(jvit.ViTConfig(**cfg))
    want = jv.apply(jvit.convert_torch_dino_weights(sd, jvit.ViTConfig(**cfg)), jnp.asarray(x))
    ours = tvit.DinoViT(tvit.ViTConfig(**cfg))
    ours.load_state_dict(tvit.convert_torch_dino_weights(
        {k: t(a) for k, a in sd.items()}, tvit.ViTConfig(**cfg)))
    _close(ours(t(x))["tokens"].detach(), want["tokens"])
    # an MAE checkpoint: wrapped, DDP-prefixed, with decoder keys and fc_norm
    mae = {"module." + k: a for k, a in sd.items() if not k.startswith("norm.")}
    mae.update({"module.fc_norm.weight": sd["norm.weight"], "module.fc_norm.bias": sd["norm.bias"],
                "module.decoder_embed.weight": np.zeros((4, 4), np.float32),
                "module.mask_token": np.zeros((1, 1, 32), np.float32)})
    got = tvit.convert_torch_mae_weights({"model": mae}, tvit.ViTConfig(**cfg))
    for k, a in tvit.convert_torch_dino_weights(sd, tvit.ViTConfig(**cfg)).items():
        torch.testing.assert_close(got[k], a, rtol=0, atol=0)


def test_pca_matches_jax():
    """pca_fit (components, mean, variance; svd_flip signs), pca_transform
    and pca_fit_transform on features with a spread spectrum."""
    rng = np.random.default_rng(7)
    basis = np.linalg.qr(rng.standard_normal((24, 24)))[0]
    x = (rng.standard_normal((500, 24)) * np.geomspace(4.0, 0.1, 24)) @ basis.T + 0.3
    x = x.astype(np.float32).reshape(20, 25, 24)
    flat = x.reshape(-1, 24)
    wc, wm, wv = jpca.pca_fit(jnp.asarray(flat), 6)
    gc, gm, gv = tpca.pca_fit(t(flat), 6)
    _close(gc, wc)
    _close(gm, wm)
    _close(gv, wv)
    _close(tpca.pca_transform(t(x), gc, gm), jpca.pca_transform(jnp.asarray(x), wc, wm))
    got = tpca.pca_fit_transform(t(x), 6)
    assert got.shape == (20, 25, 6)
    _close(got, jpca.pca_fit_transform(jnp.asarray(x), 6))


def _keep_grads():
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def test_student2d_step_matches_jax():
    """One Student2DTrainer step whose 4 x 5 prediction is resized to the
    3 x 5 target (the bilinear branch, antialiased along the shrinking
    axis): loss, gradients, parameters after AdamW."""
    jtr = jd.Student2DTrainer(jd.Distill2DConfig(d_feature=6, width=4, train=JaxTrainCfg(
        optim=JaxOptim(lr=1e-3))))
    jtr.tx = _keep_grads()
    st = jtr.init_state(jax.random.key(0), image_shape=(16, 20))
    params = _redraw(st.params, np.random.default_rng(8))
    rng = np.random.default_rng(9)
    batch = {"images": rng.uniform(0, 1, (2, 16, 20, 3)).astype(np.float32),
             "features": rng.standard_normal((2, 3, 5, 6)).astype(np.float32)}
    new, jm = jtr.train_step(JaxState(step=jnp.zeros((), jnp.int32), params=params,
                                      opt_state=jtr.tx.init(params), extra={}),
                             {k: jnp.asarray(a) for k, a in batch.items()}, jax.random.key(1))
    tr = td.Student2DTrainer(td.Distill2DConfig(d_feature=6, width=4, train=TrainConfig(
        optim=OptimConfig(lr=1e-3))), device="cpu")
    ts = tr.init_state(torch.Generator().manual_seed(0))
    ts.module.load_state_dict(flax_to_state_dict({"params": params}))
    assert ts.module(t(batch["images"])).shape == (2, 4, 5, 6)
    ts, m = tr.train_step(ts, {k: t(a) for k, a in batch.items()})
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    want_g = flax_to_state_dict({"params": jax.device_get(new.opt_state)})
    named = dict(ts.module.named_parameters())
    for n, w in want_g.items():
        torch.testing.assert_close(named[n].grad, w, rtol=0, atol=1e-4 * w.abs().max().item(),
                                   msg=lambda s: f"{n}: {s}")
    from real_robot_nerf_actor_tpu.train.trainer import make_optimizer
    tx = make_optimizer(JaxOptim(lr=1e-3))
    upd, _ = tx.update(new.opt_state, tx.init(params), params)
    for n, w in flax_to_state_dict({"params": optax.apply_updates(params, upd)}).items():
        assert ((named[n].detach() - w).abs() <= 2e-3 * (1 + 1e-3) + 1e-6 * w.abs()).all(), n


@pytest.mark.parametrize("pca", [0, 8])
def test_dump_teacher_features_matches_jax(tmp_path, pca):
    """dump_teacher_features' main over two scene npz files with a DINO
    checkpoint (npz of its arrays): each file's features and cls_attn equal
    JAX's extract_teacher_features on the JAX converter's weights (its
    script's --vit-ckpt path names a converter the JAX package lacks)."""
    cfg = dict(patch_size=8, embed_dim=48, depth=2, num_heads=6, image_size=32)
    sd = _dino_state_dict(cfg, np.random.default_rng(10))
    ckpt = str(tmp_path / "dino.npz")
    np.savez(ckpt, **sd)
    root = tmp_path / "scenes"
    root.mkdir()
    for i in range(2):
        tsd.synthesize_scene_npz(str(root / f"scene_{i}.npz"), n_views=3, hw=(24, 32), seed=i)
    info = td.main(["--data-root", str(root), "--device", "cpu", "--vit-ckpt", ckpt,
                    "--embed-dim", "48", "--depth", "2", "--feature-layer", "1",
                    "--attn-layer", "1", "--pca", str(pca)])
    assert info["teacher"] == f"converted:{ckpt}"
    jcfg = jvit.ViTConfig(**cfg)
    variables = jvit.convert_torch_dino_weights(sd, jcfg)
    for i in range(2):
        sc = tsd.load_scene(str(root / f"scene_{i}.npz"))
        wf, wa = jd.extract_teacher_features(variables, sc.images, jcfg, 1, 1,
                                             pca_components=pca or None)
        assert sc.features.shape == (3, 3, 4, pca or 48) and sc.cls_attn.shape == (3, 6, 3, 4)
        _close(sc.features, wf)
        _close(sc.cls_attn, wa)
    # without a checkpoint: the seed-drawn teacher, the same shapes
    info = td.dump_teacher_features(str(root), 1, 1, pca, embed_dim=48, depth=2,
                                    device="cpu")
    assert info["teacher"] == "random-init seed=0"
    assert info["scenes"]["scene_0.npz"] == ((3, 3, 4, pca or 48), (3, 6, 3, 4))
