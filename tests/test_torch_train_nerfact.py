"""The NeRF-Actor joint train step of the PyTorch port against the JAX
package's, at the tiny config of `__graft_entry__._dryrun_multichip_impl`
(depth 1, V 10, 16 x 32 latents, UNet encoder, 8 x 8 view, 8 rays of 6 + 4
samples, field 8 -> 2 x 16), on one device: the same weights (numpy draws
in the flax tree, converted by convert.joint_to_state_dict), the same
synthetic batch, and the JAX key's draws (SE(3) shifts, ray choice,
sampler draws) fed to the port through `draws=`, `ray_idx=` and
`render_draws=`. The JAX step's gradients come out through an optax
transform that keeps them as its state. On the CPU the port's kernels run
their plain versions; the corner-expanded case runs JAX's Pallas
`corner_lerp` in interpret mode.

Tolerances (fp32): `loss_total` and every metric 1e-5 relative, gradients
1e-4 of each tensor's largest |g| (the train-step bounds of the PerAct
step), BatchNorm statistics 1e-5 of their scale, parameters after AdamW as
test_torch_train_peract holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from real_robot_nerf_actor_tpu.models import PerceiverConfig as JaxPerceiverConfig
from real_robot_nerf_actor_tpu.models.nerf_field import NerfFieldConfig as JaxField
from real_robot_nerf_actor_tpu.ops import VoxelizerSpec as JaxSpec
from real_robot_nerf_actor_tpu.ops import grid_sample as jg
from real_robot_nerf_actor_tpu.render import RendererConfig as JaxRenderCfg
from real_robot_nerf_actor_tpu.train.nerfact import NerfActConfig as JaxCfg
from real_robot_nerf_actor_tpu.train.nerfact import NerfActTrainer as JaxTrainer
from real_robot_nerf_actor_tpu.train.peract import PerActConfig as JaxPerAct
from real_robot_nerf_actor_tpu.train.trainer import OptimConfig as JaxOptim
from real_robot_nerf_actor_tpu.train.trainer import TrainConfig as JaxTrainCfg
from real_robot_nerf_actor_tpu.train.trainer import TrainState as JaxState
from real_robot_nerf_actor_tpu.train.trainer import make_optimizer
from real_robot_nerf_actor_tpu_torch.convert import joint_to_state_dict, load_optax_state
from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig, PerceiverConfig
from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec
from real_robot_nerf_actor_tpu_torch.ops import grid_sample as tg
from real_robot_nerf_actor_tpu_torch.render import RendererConfig
from real_robot_nerf_actor_tpu_torch.train import nerfact
from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig, NerfActTrainer
from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig
from real_robot_nerf_actor_tpu_torch.train.trainer import OptimConfig, TrainConfig

BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
MODEL = dict(depth=1, voxel_size=10, num_latents=16, latent_dim=32, im_channels=8,
             cross_dim_head=8, latent_dim_head=8, latent_heads=2, voxel_patch_size=5,
             final_dim=8, lang_emb_dim=16, lang_max_seq_len=4, num_rotation_classes=72,
             input_encoder="unet", return_voxel_feat=True)
RENDER = dict(image_width=8, image_height=8, n_coarse=6, n_fine=4, n_fine_depth=2,
              ray_chunk_size=8)
FIELD = dict(d_latent=8, d_embed=4, d_hidden=16, n_blocks=2, combine_layer=1,
             coord_bounds=BOUNDS)
B = 2
LR = 1e-3
INVARIANT = "policy.trans_decoder.bias"   # see test_torch_train_peract


def _configs(optim=None, **render_kw):
    """The dryrun's tiny NerfActConfig of both packages."""
    optim = optim or {"lr": LR}
    render_kw = dict(RENDER, **render_kw)
    jax_cfg = JaxCfg(
        peract=JaxPerAct(model=JaxPerceiverConfig(**MODEL),
                         voxelizer=JaxSpec(voxel_size=10, feature_size=3, max_num_coords=512),
                         coord_bounds=BOUNDS,
                         train=JaxTrainCfg(num_steps=1, optim=JaxOptim(**optim))),
        renderer=JaxRenderCfg(field=JaxField(**FIELD), **render_kw))
    cfg = NerfActConfig(
        peract=PerActConfig(model=PerceiverConfig(**MODEL),
                            voxelizer=VoxelizerSpec(voxel_size=10, feature_size=3,
                                                    max_num_coords=512),
                            coord_bounds=BOUNDS,
                            train=TrainConfig(num_steps=1, optim=OptimConfig(**optim))),
        renderer=RendererConfig(field=NerfFieldConfig(**FIELD), **render_kw))
    return jax_cfg, cfg


def _numpy_state(jtr, seed=5):
    """JAX init_state's trees, every leaf redrawn with numpy: kernels
    N(0, 1 / fan_in), biases N(0, 0.1^2), LayerNorm and BatchNorm scales
    1 + N(0, 0.1^2), positions and latents N(0, 1), running means
    N(0, 0.3^2) and variances U(0.5, 1.5); the field's density bias 2.

    The UNet's 1x1 head (which makes d0) is drawn at 0.05 of that scale.
    d0's scale sets how far the spatial softmax at T = 0.01 amplifies the
    two packages' fp32 rounding into every gradient: at full scale d0
    reaches |3|, the two forwards agree to 1.3e-6 of d0's scale (q_trans
    2.2e-6), and yet the gradients differ by up to 1.7e-4 of a tensor's
    largest |g|, with or without the rendering loss; at 0.05 by 2.4e-5."""
    state = jtr.init_state(jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        s = np.shape(a)
        if name in ("pos_encoding", "latents"):
            x = rng.standard_normal(s)
        elif name == "var":
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

    params = jax.tree_util.tree_map_with_path(draw, state.params)
    params["policy"]["encoder_3d"]["Conv_0"] = jax.tree.map(
        lambda a: 0.05 * a, params["policy"]["encoder_3d"]["Conv_0"])
    params["nerf"]["mlp_coarse"]["lin_out_bias"] = (
        params["nerf"]["mlp_coarse"]["lin_out_bias"].at[3].set(2.0))
    extra = jax.tree_util.tree_map_with_path(draw, state.extra)
    return params, extra


def _jax_batch(jax_cfg):
    return {k: np.asarray(v) for k, v in
            next(JaxTrainer(jax_cfg).synthetic_data(batch_size=B)).items()}


def _draws(key, rc):
    """The JAX step's draws for `key`, as its train_step and
    rendering_loss split it: (SE(3) uniforms, ray_idx, render draws)."""
    k_aug, k_render = jax.random.split(key)
    aug = jax.vmap(lambda k: jax.random.uniform(k, (3,), minval=-1.0, maxval=1.0))(
        jax.random.split(k_aug, B))
    k_sel, k_r = jax.random.split(k_render)
    ray_idx = jax.random.randint(k_sel, (rc.ray_chunk_size,), 0,
                                 rc.image_height * rc.image_width)
    k_coarse, k_fine, k_fdepth, _, _ = jax.random.split(k_r, 5)
    k_u, k_j = jax.random.split(k_fine)
    r, nf = rc.ray_chunk_size, rc.n_fine - rc.n_fine_depth
    d = {"coarse_u": jax.random.uniform(k_coarse, (r, rc.n_coarse)),
         "fine_u": jax.random.uniform(k_u, (r, nf)),
         "fine_jitter": jax.random.uniform(k_j, (r, nf)),
         "fine_depth_eps": jax.random.normal(k_fdepth, (r, rc.n_fine_depth))}
    t = torch.from_numpy
    return dict(draws=t(np.array(aug)), ray_idx=t(np.array(ray_idx)),
                render_draws={k: t(np.array(v)) for k, v in d.items()})


def _keep_grads():
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _port(cfg, params, extra):
    tr = NerfActTrainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    state.module.load_state_dict(joint_to_state_dict(params, extra))
    return tr, state


def _assert_params_after_adamw(got, want, lr, share=1e-3):
    """At step 1 an AdamW update is lr * g / (|g| + 1e-8): an entry whose
    gradient lies within the gradients' tolerance of zero may move by up to
    2 lr apart; every other entry agrees to 1e-3 lr plus fp32 rounding."""
    moved = 0
    for n, w in want.items():
        gap = (got[n] - w).abs()
        assert (gap <= 2 * lr * (1 + 1e-3) + 1e-6 * w.abs()).all(), n
        moved += int((gap > 1e-3 * lr + 1e-6 * w.abs()).sum())
    assert moved <= share * sum(w.numel() for w in want.values()), moved


@pytest.fixture(scope="module")
def steps():
    cache = {}

    def get(path):
        if path not in cache:
            render_kw = {"expanded": {"fused_gather": True},
                         "render_only": {"ray_chunk_size": 64, "n_coarse": 16}}.get(path, {})
            backend = "pallas" if path == "expanded" else "xla"
            jax_cfg, cfg = _configs(**render_kw)
            if path == "render_only":
                jax_cfg = dataclasses.replace(jax_cfg, lambda_bc=0.0)
                cfg = dataclasses.replace(cfg, lambda_bc=0.0)
            old = (jg.FUSED_LERP_BACKEND, tg.FUSED_LERP_BACKEND)
            jg.FUSED_LERP_BACKEND = tg.FUSED_LERP_BACKEND = backend
            try:
                jtr = JaxTrainer(jax_cfg)
                jtr.tx = _keep_grads()
                params, extra = _numpy_state(jtr)
                batch = _jax_batch(jax_cfg)
                key = jax.random.key(1)
                state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                                 opt_state=jtr.tx.init(params), extra=extra)
                new, metrics = jax.jit(jtr.train_step)(
                    state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
                tr, st = _port(cfg, params, extra)
                st, m = tr.train_step(st, {k: torch.from_numpy(v) for k, v in batch.items()},
                                      **_draws(key, jax_cfg.renderer))
            finally:
                jg.FUSED_LERP_BACKEND, tg.FUSED_LERP_BACKEND = old
            named = dict(st.module.named_parameters())
            cache[path] = dict(
                jax_m={k: float(v) for k, v in metrics.items()},
                m={k: v.item() for k, v in m.items()},
                params=params, grads=new.opt_state,
                jax_g=joint_to_state_dict(jax.device_get(new.opt_state)),
                g={n: p.grad.clone() for n, p in named.items()},
                p={n: p.detach().clone() for n, p in named.items()},
                stats=dict(st.module.named_buffers()),
                jax_stats=joint_to_state_dict({}, jax.device_get(new.extra)),
                optim=jax_cfg.peract.train.optim)
        return cache[path]
    return get


@pytest.mark.parametrize("path", ["gathers", "expanded", "render_only"])
def test_train_step_matches_jax(steps, path):
    """One joint step, fp32: loss_total and every metric (BC, rgb, embed,
    psnr), every gradient of policy and field, the BatchNorm statistics
    after the step, and the parameters after AdamW. "gathers": the tiny
    config as written (8 gathers a sample); "expanded": fused_gather true
    with FUSED_LERP_BACKEND "pallas" in both packages; "render_only":
    lambda_bc 0, so that the policy's gradients are the rendering loss's
    alone (at this size they are under 1e-5 of the BC loss's, so the other
    two cases hold them only within the BC gradients' tolerance), over 64
    rays of 16 + 4 samples: the scene covers 6 of the view's 64 pixels, and
    8 rays of 6 samples may miss it (the key's draws do)."""
    r = steps(path)
    assert "loss_total" in r["m"] and set(r["m"]) == set(r["jax_m"])
    for k, w in r["jax_m"].items():
        np.testing.assert_allclose(r["m"][k], w, rtol=1e-5, err_msg=k)
    assert set(r["g"]) == set(r["jax_g"])
    assert any(n.startswith("nerf.") for n in r["g"])
    assert r["g"]["policy.encoder_3d.Conv_0.weight"].abs().max() > 0
    top = max(w.abs().max().item() for w in r["jax_g"].values())
    for n, w in r["jax_g"].items():
        if n == INVARIANT:
            assert max(w.abs().max().item(), r["g"][n].abs().max().item()) <= 1e-5 * top
            continue
        torch.testing.assert_close(r["g"][n], w, rtol=0, atol=1e-4 * w.abs().max().item(),
                                   msg=lambda m: f"{n}: {m}")
    assert r["jax_stats"] and set(r["jax_stats"]) == set(r["stats"])
    for n, w in r["jax_stats"].items():
        torch.testing.assert_close(r["stats"][n], w, rtol=0,
                                   atol=1e-5 * w.abs().max().item(), msg=lambda m: f"{n}: {m}")
    tx = make_optimizer(r["optim"])
    upd, _ = tx.update(r["grads"], tx.init(r["params"]), r["params"])
    want_p = joint_to_state_dict(optax.apply_updates(r["params"], upd))
    _assert_params_after_adamw(r["p"], want_p, r["optim"].lr)


def test_synthetic_data_matches_jax():
    """The port's joint batches are the JAX package's: the PerAct fields,
    the splatted view, its pose, focal and gt_embed."""
    jax_cfg, cfg = _configs()
    want = next(JaxTrainer(jax_cfg).synthetic_data(batch_size=3, seed=2))
    got = next(NerfActTrainer(cfg, device="cpu").synthetic_data(batch_size=3, seed=2))
    assert set(got) == set(want) and {"gt_rgb", "gt_pose", "focal", "gt_embed"} <= set(got)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)
    assert got["gt_rgb"].sum() > 0


def test_converted_optax_state_resumes_on_the_same_trajectory():
    """A JAX joint state (params, batch statistics, optax state with clip
    and a cosine schedule) after one step, carried into the port, then one
    more step in each package on the same batch and draws: the same losses
    and the same parameters after the second update."""
    optim = dict(lr=LR, grad_clip=1.0, schedule="cosine", warmup_steps=1, decay_steps=10)
    jax_cfg, cfg = _configs(optim)
    jtr = JaxTrainer(jax_cfg)
    params, extra = _numpy_state(jtr)
    batch = _jax_batch(jax_cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     opt_state=jtr.tx.init(params), extra=extra)
    step = jax.jit(jtr.train_step)
    state, _ = step(state, jbatch, jax.random.key(1))
    tr, st = _port(cfg, jax.device_get(state.params), jax.device_get(state.extra))
    load_optax_state(st.optimizer, jax.tree.map(np.asarray, state.opt_state))
    assert st.optimizer.count == 1
    state, want_m = step(state, jbatch, jax.random.key(2))
    st, got_m = tr.train_step(st, {k: torch.from_numpy(v) for k, v in batch.items()},
                              **_draws(jax.random.key(2), jax_cfg.renderer))
    for k, w in want_m.items():
        np.testing.assert_allclose(got_m[k].item(), float(w), rtol=1e-5, err_msg=k)
    want_p = joint_to_state_dict(jax.device_get(state.params))
    got_p = {n: p.detach() for n, p in st.module.named_parameters()}
    _assert_params_after_adamw(got_p, want_p, LR, share=3e-3)


def test_cli_trains_evaluates_and_resumes(tmp_path, capsys):
    """`python -m real_robot_nerf_actor_tpu_torch.train.nerfact` at the tiny
    size on the CPU: two steps with a render eval and a checkpoint, then a
    second run that resumes from it and takes the third step."""
    overrides = [f"peract.model.{k}={v}" for k, v in MODEL.items()
                 if k not in ("input_encoder", "return_voxel_feat")]
    overrides += ["peract.voxelizer.voxel_size=10", "peract.voxelizer.max_num_coords=512",
                  "peract.train.log_every=1", "peract.train.eval_every=2",
                  "peract.train.prefetch=0"]
    overrides += [f"renderer.{k}={v}" for k, v in RENDER.items()]
    overrides += [f"renderer.field.{k}={v}" for k, v in FIELD.items() if k != "coord_bounds"]
    args = ["--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt")]
    for o in overrides:
        args += ["-o", o]
    state = nerfact.main(args + ["--steps", "2"])
    assert state.step == 2
    logged = capsys.readouterr().err
    assert "eval_psnr" in logged and "loss_total" in logged
    state = nerfact.main(args + ["--steps", "3"])
    assert state.step == 3 and "resumed from step 2" in capsys.readouterr().out
    stats = state.module["policy"].encoder_3d.ConvBnReLU3D_0.BatchNorm_0.running_var
    assert not torch.equal(stats, torch.ones_like(stats))


def test_trainer_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NerfActTrainer(NerfActConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nerfact.main(["--steps", "1"])


def test_config_dataclass_matches_jax():
    from real_robot_nerf_actor_tpu.utils.config import to_dict as jax_to_dict
    from real_robot_nerf_actor_tpu_torch.utils.config import to_dict
    assert to_dict(NerfActConfig()) == jax_to_dict(JaxCfg())
