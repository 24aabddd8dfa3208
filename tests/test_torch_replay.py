"""Training on recorded demos with language, the port against the JAX
package, at a tiny size on the CPU.

A multi-kitchen dataset (2 kitchens x 2 tasks x 2 demos of 5 keyframes,
12 x 16 views, 8-dim teacher embeds, 6000-point clouds) is written once by
the port's writer and read by both packages. The policy is the joint
step's tiny config (depth 1, V 10, UNet encoder) with 77 language tokens of
width 512, the field 8 -> 2 x 16. Tolerances:
  - the kitchen writer: every file equal to the JAX writer's (PLY, .npy,
    the xarm text, calibration.json, manifest.json), PNG pixels equal,
    lang_embs.npz aside (its text tower's random weights come from a
    torch.Generator);
  - replay batches: the first 6 of replay_data / multi_replay_data equal,
    labels included, under uniform and demo_cycle;
  - one joint train_step on the first replay batch: the bounds of
    test_torch_train_nerfact (fp32 loss and metrics 1e-5 relative,
    gradients 1e-4 of each tensor's largest |g|);
  - the replay evals on converted weights and JAX's render draws: every
    decode metric equal, PSNRs within 1e-3 dB;
  - the renderer's kernel pack after a train step (a fault the port had):
    render_eval on the pallas_bf16 / pallas_int8 field within the frame
    check of chip_smoke.py (largest |rgb gap| 0.04, PSNR 45 dB) of the xla
    render, before and after the step.
"""
import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from real_robot_nerf_actor_tpu.data import kitchen as jkitchen
from real_robot_nerf_actor_tpu.data.multitask import load_multitask_entries as j_entries
from real_robot_nerf_actor_tpu.models import PerceiverConfig as JaxPerceiverConfig
from real_robot_nerf_actor_tpu.models.nerf_field import NerfFieldConfig as JaxField
from real_robot_nerf_actor_tpu.ops import VoxelizerSpec as JaxSpec
from real_robot_nerf_actor_tpu.render import RendererConfig as JaxRenderCfg
from real_robot_nerf_actor_tpu.train.nerfact import NerfActConfig as JaxCfg
from real_robot_nerf_actor_tpu.train.nerfact import NerfActTrainer as JaxTrainer
from real_robot_nerf_actor_tpu.train.peract import PerActConfig as JaxPerAct
from real_robot_nerf_actor_tpu.train.peract import PerActTrainer as JaxPerActTrainer
from real_robot_nerf_actor_tpu.train.trainer import TrainState as JaxState
from real_robot_nerf_actor_tpu_torch.convert import joint_to_state_dict
from real_robot_nerf_actor_tpu_torch.data import kitchen
from real_robot_nerf_actor_tpu_torch.data.multitask import load_multitask_entries
from real_robot_nerf_actor_tpu_torch.data.png import read_png
from real_robot_nerf_actor_tpu_torch.models import NerfFieldConfig, PerceiverConfig
from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec
from real_robot_nerf_actor_tpu_torch.render import RendererConfig
from real_robot_nerf_actor_tpu_torch.render.renderer import psnr
from real_robot_nerf_actor_tpu_torch.train import nerfact, peract
from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig, NerfActTrainer
from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig, PerActTrainer
from real_robot_nerf_actor_tpu_torch.train.trainer import OptimConfig, TrainConfig

BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
MODEL = dict(depth=1, voxel_size=10, num_latents=16, latent_dim=32, im_channels=8,
             cross_dim_head=8, latent_dim_head=8, latent_heads=2, voxel_patch_size=5,
             final_dim=8, lang_emb_dim=512, lang_max_seq_len=77, num_rotation_classes=72,
             input_encoder="unet", return_voxel_feat=True)
H, W = 12, 16
RENDER = dict(image_width=W, image_height=H, n_coarse=6, n_fine=4, n_fine_depth=2,
              ray_chunk_size=8, lambda_depth=0.1)
FIELD = dict(d_latent=8, d_embed=8, d_hidden=16, n_blocks=2, combine_layer=1,
             coord_bounds=BOUNDS)
NPTS = 8192
KITCHEN = dict(image_hw=(H, W), d_embed=8, n_points=4000)
B = 2
RGB_TOL, PSNR_MIN = 0.04, 45.0   # chip_smoke.py's frame check


def _configs(field=None, optim=None, **render_kw):
    field = dict(FIELD, **(field or {}))
    render = dict(RENDER, **render_kw)
    optim = optim or {}
    spec = dict(voxel_size=10, feature_size=3, max_num_coords=NPTS)
    jax_cfg = JaxCfg(
        peract=JaxPerAct(model=JaxPerceiverConfig(**MODEL), voxelizer=JaxSpec(**spec),
                         coord_bounds=BOUNDS),
        renderer=JaxRenderCfg(field=JaxField(**field), **render))
    cfg = NerfActConfig(
        peract=PerActConfig(model=PerceiverConfig(**MODEL), voxelizer=VoxelizerSpec(**spec),
                            coord_bounds=BOUNDS,
                            train=TrainConfig(num_steps=1, optim=OptimConfig(**optim))),
        renderer=RendererConfig(field=NerfFieldConfig(**field), **render))
    return jax_cfg, cfg


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitchens") / "multi")
    kitchen.write_multi_kitchen_dataset(root, n_kitchens=2, n_tasks=2, n_demos=2,
                                        device="cpu", **KITCHEN)
    return root


def _numpy_state(jtr, seed=5):
    """JAX init_state's trees, every leaf redrawn with numpy (as
    test_torch_train_nerfact draws them, the UNet's 1x1 head at 0.05 of its
    scale and the field's density bias 2)."""
    state = jtr.init_state(jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name, s = path[-1].key, np.shape(a)
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
    return params, jax.tree_util.tree_map_with_path(draw, state.extra)


def _port_state(tr, params, extra):
    state = tr.init_state(torch.Generator().manual_seed(0))
    state.module.load_state_dict(joint_to_state_dict(jax.device_get(params),
                                                     jax.device_get(extra)))
    return state


# ------------------------------------------------------------- the writer
@pytest.mark.parametrize("variant", ["grasp", "task_two_views"])
def test_kitchen_writer_matches_jax(tmp_path, variant):
    kw = dict(n_demos=2, n_keyframes=4, image_hw=(24, 32), d_embed=8, n_points=4000)
    if variant != "grasp":
        kw.update(task=1, scene_seed=7, n_train_views=2, camera_eye=(1.0, -0.6, 0.9))
    want = jkitchen.write_kitchen_demos(str(tmp_path / "jax"), **kw)
    got = kitchen.write_kitchen_demos(str(tmp_path / "port"), **kw)
    assert got == want
    n = 0
    for root, _, files in os.walk(tmp_path / "jax"):
        for f in files:
            a = os.path.join(root, f)
            b = a.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
            if f.endswith(".png"):
                np.testing.assert_array_equal(read_png(b), np.asarray(Image.open(a)))
            else:
                assert filecmp.cmp(a, b, shallow=False), f
            n += 1
    # calibration, 2 pose files; per keyframe a cloud, a holdout view and
    # an rgb, depth and embed per training camera
    per_kf = 2 + 3 * (2 if variant != "grasp" else 1)
    assert n == sum(len(fs) for _, _, fs in os.walk(tmp_path / "port"))
    assert n == 3 + 2 * (5 if variant != "grasp" else 4) * per_kf


def test_multi_kitchen_writer_matches_jax(tmp_path, monkeypatch):
    """Every file but lang_embs.npz equal; the text tower is held to JAX's
    in test_torch_clip_text.py. JAX's tower is stubbed here (zeros)."""
    monkeypatch.setattr(jkitchen, "encode_task_instructions",
                        lambda ins, seed=0: np.zeros((len(ins), 77, 512), np.float32))
    kw = dict(n_kitchens=2, n_tasks=3, n_demos=1, seed=3, **KITCHEN)
    want = jkitchen.write_multi_kitchen_dataset(str(tmp_path / "jax"), **kw)
    got = kitchen.write_multi_kitchen_dataset(str(tmp_path / "port"), device="cpu", **kw)
    assert got == want
    for root, _, files in os.walk(tmp_path / "jax"):
        for f in files:
            a = os.path.join(root, f)
            b = a.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
            if f.endswith(".png"):
                np.testing.assert_array_equal(read_png(b), np.asarray(Image.open(a)))
            elif f != "lang_embs.npz":
                assert filecmp.cmp(a, b, shallow=False), f
    lang = np.load(tmp_path / "port" / "lang_embs.npz")
    assert lang["embs"].shape == (3, 77, 512) and np.isfinite(lang["embs"]).all()
    assert list(lang["instructions"]) == want["instructions"]
    got_e = load_multitask_entries(str(tmp_path / "port"), exclude_demos=(0,))
    want_e = j_entries(str(tmp_path / "port"), exclude_demos=(0,))
    for g, w in zip(got_e, want_e):
        assert {k: v for k, v in g.items() if k != "lang"} == \
            {k: v for k, v in w.items() if k != "lang"}
        np.testing.assert_array_equal(g["lang"], w["lang"])


# ---------------------------------------------------------------- batches
@pytest.mark.parametrize("sample_mode", ["uniform", "demo_cycle"])
@pytest.mark.parametrize("which", ["peract_replay_data", "nerfact_multi_replay_data"])
def test_replay_batches_match_jax(dataset, sample_mode, which):
    jax_cfg, cfg = _configs()
    if which == "peract_replay_data":
        lang = np.random.default_rng(0).standard_normal((77, 512)).astype(np.float32)
        args = (os.path.join(dataset, "k1_t0"), 2, B, 4)
        kw = dict(lang_embs=lang, exclude_demos=(0,), sample_mode=sample_mode)
        want = JaxPerActTrainer(jax_cfg.peract).replay_data(*args, **kw)
        got = PerActTrainer(cfg.peract, device="cpu").replay_data(*args, **kw)
    else:
        want = JaxTrainer(jax_cfg).multi_replay_data(
            j_entries(dataset, exclude_demos=(1,)), B, 4, sample_mode=sample_mode)
        got = NerfActTrainer(cfg, device="cpu").multi_replay_data(
            load_multitask_entries(dataset, exclude_demos=(1,)), B, 4,
            sample_mode=sample_mode)
    for i in range(6):
        w, g = next(want), next(got)
        assert set(w) == set(g)
        if which != "peract_replay_data":
            assert {"gt_rgb", "gt_pose", "focal", "gt_embed", "gt_depth"} <= set(g)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=f"{i} {k}")


def test_joint_trainer_checks_the_recording(dataset, tmp_path):
    _, cfg = _configs()
    root = os.path.join(dataset, "k0_t0")
    for render_kw, field_kw, match in (({"image_width": 8}, {}, "renderer config"),
                                       ({}, {"d_embed": 4}, "d_embed")):
        bad = dataclasses.replace(cfg, renderer=dataclasses.replace(
            cfg.renderer, field=dataclasses.replace(cfg.renderer.field, **field_kw),
            **render_kw))
        with pytest.raises(ValueError, match=match):
            NerfActTrainer(bad, device="cpu").replay_data(root, 2)
    kitchen.write_kitchen_demos(str(tmp_path / "k"), n_demos=1, **KITCHEN)
    os.remove(tmp_path / "k" / "real0" / "rgb0.png")
    with pytest.raises(ValueError, match="no ground-truth views"):
        NerfActTrainer(cfg, device="cpu").replay_data(str(tmp_path / "k"), 1)
    with pytest.raises(ValueError, match="removed every demo"):
        next(PerActTrainer(cfg.peract, device="cpu").replay_data(root, 2,
                                                                 exclude_demos=(0, 1)))


# -------------------------------------------------------------- the step
def _render_draws(key, rc, r):
    """JAX rendering_loss's draws of `key` for r rays (test_torch_train_nerfact)."""
    k_coarse, k_fine, k_fdepth, _, _ = jax.random.split(key, 5)
    k_u, k_j = jax.random.split(k_fine)
    nf = rc.n_fine - rc.n_fine_depth
    return {"coarse_u": jax.random.uniform(k_coarse, (r, rc.n_coarse)),
            "fine_u": jax.random.uniform(k_u, (r, nf)),
            "fine_jitter": jax.random.uniform(k_j, (r, nf)),
            "fine_depth_eps": jax.random.normal(k_fdepth, (r, rc.n_fine_depth))}


def test_joint_step_on_the_first_replay_batch_matches_jax(dataset):
    jax_cfg, cfg = _configs()
    jtr = JaxTrainer(jax_cfg)
    jtr.tx = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))   # keeps the gradients
    params, extra = _numpy_state(jtr)
    batch = {k: np.asarray(v) for k, v in next(jtr.multi_replay_data(
        j_entries(dataset), B, 0)).items()}
    key = jax.random.key(1)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     opt_state=jtr.tx.init(params), extra=extra)
    new, jm = jax.jit(jtr.train_step)(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                      key)
    tr = NerfActTrainer(cfg, device="cpu")
    st = _port_state(tr, params, extra)
    port_batch = next(tr.multi_replay_data(load_multitask_entries(dataset), B, 0))
    for k, v in batch.items():
        np.testing.assert_array_equal(port_batch[k].numpy(), v)
    k_aug, k_render = jax.random.split(key)
    aug = jax.vmap(lambda k: jax.random.uniform(k, (3,), minval=-1.0, maxval=1.0))(
        jax.random.split(k_aug, B))
    k_sel, k_r = jax.random.split(k_render)
    rc = jax_cfg.renderer
    ray_idx = jax.random.randint(k_sel, (rc.ray_chunk_size,), 0, H * W)
    st, m = tr.train_step(st, port_batch, draws=torch.from_numpy(np.array(aug)),
                          ray_idx=torch.from_numpy(np.array(ray_idx)),
                          render_draws={k: torch.from_numpy(np.array(v)) for k, v in
                                        _render_draws(k_r, rc, rc.ray_chunk_size).items()})
    assert set(m) == set(jm), set(m) ^ set(jm)
    assert "loss_embed_fine" in m and "loss_depth_fine" in m
    for k, w in jm.items():
        np.testing.assert_allclose(m[k].item(), float(w), rtol=1e-5, err_msg=k)
    want_g = joint_to_state_dict(jax.device_get(new.opt_state))
    got_g = {n: p.grad for n, p in st.module.named_parameters()}
    assert set(got_g) == set(want_g)
    top = max(w.abs().max().item() for w in want_g.values())
    for n, w in want_g.items():
        if n == "policy.trans_decoder.bias":   # a zero gradient up to rounding
            assert got_g[n].abs().max().item() <= 1e-5 * top
            continue
        torch.testing.assert_close(got_g[n], w, rtol=0, atol=1e-4 * w.abs().max().item(),
                                   msg=lambda msg: f"{n}: {msg}")
    assert got_g["policy.lang_preprocess.weight"].abs().max() > 0   # language trains


# ---------------------------------------------------------------- evals
def _tile_draws(rc):
    """JAX render_image's draws for key(step): one mapping per tile."""
    def draws(step):
        n = rc.image_width * rc.image_height
        tile = min(rc.render_tile, n)
        out = []
        for kk in jax.random.split(jax.random.key(step), -(-n // tile)):
            d = _render_draws(kk, rc, tile)
            out.append({k: torch.from_numpy(np.array(v)) for k, v in d.items()})
        return out
    return draws


@pytest.fixture(scope="module")
def evals(dataset):
    jax_cfg, cfg = _configs()
    jtr = JaxTrainer(jax_cfg)
    params, extra = _numpy_state(jtr, seed=6)
    js = JaxState(step=jnp.zeros((), jnp.int32), params=params, opt_state=None, extra=extra)
    tr = NerfActTrainer(cfg, device="cpu")
    st = _port_state(tr, params, extra)
    draws = _tile_draws(jax_cfg.renderer)
    out = {}
    root = os.path.join(dataset, "k0_t1")
    batch = next(jtr.replay_data(root, 2, 1, seed=2))
    tbatch = next(tr.replay_data(root, 2, 1, seed=2))
    out["single"] = (
        jtr.make_replay_eval(root, 2, exclude_demos=(1,), eval_batch=batch)(js, 3),
        tr.make_replay_eval(root, 2, exclude_demos=(1,), eval_batch=tbatch,
                            render_draws=draws)(st, 3))
    decode, langs = tr._decode, []

    def spy(state, cloud, lang):   # the language of every decode
        langs.append(float(lang.abs().max()))
        return decode(state, cloud, lang)

    tr._decode = spy
    out["multi"] = (
        jtr.make_multi_replay_eval(j_entries(dataset, exclude_demos=(1,)))(js, 5),
        tr.make_multi_replay_eval(load_multitask_entries(dataset, exclude_demos=(1,)),
                                  render_draws=draws)(st, 5))
    out["multi_decode_langs"] = langs
    return out


@pytest.mark.parametrize("which", ["single", "multi"])
def test_replay_eval_matches_jax(evals, which):
    want, got = evals[which]
    assert set(got) == set(want)
    keys = {"eval_psnr", "eval_psnr_fg", "eval_psnr_holdout", "bc_train_exact",
            "bc_train_within1", "bc_holdout_exact", "bc_score", "bc_render_score"}
    if which == "multi":
        keys |= {"bc_t0_exact", "bc_t1_within1", "bc_zerolang_exact"}
        # 4 recordings x 2 demos x 4 transitions with their task's language,
        # and the 16 of the training demos again with zeros
        langs = evals["multi_decode_langs"]
        assert len(langs) == 48 and sum(v == 0.0 for v in langs) == 16
    assert keys <= set(got)
    for k, w in want.items():
        if "psnr" in k:
            assert abs(got[k] - float(w)) <= 1e-3, k
        elif k == "bc_render_score":
            assert abs(got[k] - float(w)) <= 1e-5, k    # 0.01 x a PSNR
        else:
            assert got[k] == float(w), k


# ------------------------------------------------------------ entry points
def _overrides():
    out = [f"peract.model.{k}={v}" for k, v in MODEL.items()
           if k not in ("input_encoder", "return_voxel_feat")]
    out += ["peract.voxelizer.voxel_size=10", f"peract.voxelizer.max_num_coords={NPTS}",
            "peract.train.log_every=1", "peract.train.eval_every=2",
            "peract.train.prefetch=0", "peract.train.best_key=bc_render_score"]
    out += [f"renderer.{k}={v}" for k, v in RENDER.items()]
    out += [f"renderer.field.{k}={v}" for k, v in FIELD.items() if k != "coord_bounds"]
    return [a for o in out for a in ("-o", o)]


@pytest.mark.parametrize("data", ["multi_root", "data_root_demo_cycle"])
def test_nerfact_cli_trains_on_recorded_demos(dataset, tmp_path, capsys, data):
    """Two steps with the replay eval at step 2 and the best checkpoint
    chosen on bc_render_score."""
    args = ["--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"), "--steps", "2",
            "--eval-save-dir", str(tmp_path / "panels")] + _overrides()
    if data == "multi_root":
        args += ["--multi-root", dataset, "--exclude-demos", "1"]
    else:
        args += ["--data-root", os.path.join(dataset, "k1_t1"), "--n-demos", "2",
                 "--sample-mode", "demo_cycle", "--batch-size", "2"]
    state = nerfact.main(args)
    assert state.step == 2
    out = capsys.readouterr()
    assert "bc_render_score" in out.err and "eval_psnr_holdout" in out.err
    # the JAX package's panel names: per kitchen on the multi-kitchen eval,
    # render_eval's on one recording
    panels = sorted(os.listdir(tmp_path / "panels"))
    if data != "multi_root":
        assert "demo_cycle: optimizer window 2" in out.out
        assert panels == ["render_000002.png"]
    else:
        assert "bc_zerolang_exact" in out.err and "bc_holdout_exact" in out.err
        assert panels == ["k0_render_000002.png", "k1_render_000002.png"]
    assert read_png(str(tmp_path / "panels" / panels[0])).shape == (H, 4 * W + 6, 3)
    best = json.loads((tmp_path / "ckpt_best" / "best.json").read_text())
    assert best["key"] == "bc_render_score" and best["step"] == 2


def test_nerfact_cli_warm_starts(dataset, tmp_path):
    """--init-policy-from grafts the donor's policy parameters into a fresh
    run (the field and the BatchNorm statistics stay fresh);
    --init-params-from takes every parameter the donor shares."""
    base = ["--device", "cpu", "--multi-root", dataset] + _overrides()
    donor = nerfact.main(base + ["--ckpt-dir", str(tmp_path / "a"), "--steps", "1",
                                 "-o", "peract.train.seed=1"])
    fresh = nerfact.main(base + ["--ckpt-dir", str(tmp_path / "f"), "--steps", "0"])
    donor_p = dict(donor.module.named_parameters())
    fresh_p = dict(fresh.module.named_parameters())
    assert any(not torch.equal(p, donor_p[n]) for n, p in fresh_p.items()
               if n.startswith("nerf."))
    for flag, name in (("--init-policy-from", "b"), ("--init-params-from", "c")):
        state = nerfact.main(base + ["--ckpt-dir", str(tmp_path / name), "--steps", "0",
                                     flag, str(tmp_path / "a")])
        assert state.step == 0
        for n, p in state.module.named_parameters():
            from_donor = n.startswith("policy.") or flag == "--init-params-from"
            assert torch.equal(p, (donor_p if from_donor else fresh_p)[n]), n
        for n, b in state.module.named_buffers():
            torch.testing.assert_close(b, dict(fresh.module.named_buffers())[n], msg=n)


@pytest.mark.parametrize("data", ["data_root", "multi_root"])
def test_peract_cli_trains_on_recorded_demos(dataset, tmp_path, data):
    args = ["--device", "cpu", "--steps", "2", "--ckpt-dir", str(tmp_path / "ckpt"),
            "-o", "model.depth=1", "-o", "model.voxel_size=10", "-o", "voxelizer.voxel_size=10",
            "-o", f"voxelizer.max_num_coords={NPTS}", "-o", "model.num_latents=16",
            "-o", "model.latent_dim=32", "-o", "train.log_every=1", "-o", "train.prefetch=0"]
    args += (["--multi-root", dataset] if data == "multi_root"
             else ["--data-root", os.path.join(dataset, "k0_t0"), "--n-demos", "2"])
    assert peract.main(args).step == 2


# ---------------------------------------------------- the kernels' pack
@pytest.mark.parametrize("backend", ["pallas_bf16", "pallas_int8"])
def test_kernel_render_follows_the_trained_field(dataset, backend):
    """render_eval on the kernel backend (the CPU runs the kernels' plain
    versions) against the plain field ("xla"), same state and draws, before
    and after one train step at lr 1e-2: within the frame check both times,
    and the kernel render moves with the weights (a stale pack would fail
    the check after the step). Static int8 scales are calibrated once per
    render. The field computes in bf16 in both renders."""
    field = dict(compute_dtype="bfloat16", mask_outside=True)
    _, cfg_x = _configs(field=field, optim=dict(lr=1e-2))
    _, cfg_k = _configs(field=dict(field, mlp_backend=backend,
                                   int8_static_act=backend == "pallas_int8"))
    trainer, evaler = NerfActTrainer(cfg_x, device="cpu"), NerfActTrainer(cfg_k, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    with torch.no_grad():   # random field weights everywhere, a dense frame
        for n, p in state.module["nerf"].named_parameters():
            p.normal_(0.0, 0.3 if p.dim() == 2 else 0.05,
                      generator=torch.Generator().manual_seed(len(n)))
        state.module["nerf"].mlp_coarse.lin_out_bias[3] = 1.0
    batch = next(trainer.multi_replay_data(load_multitask_entries(dataset), 1, 0))
    frames = {}

    def render(tr, name):
        inner = tr.renderer.render_image

        def spy(*a, **k):
            frames[name] = out = inner(*a, **k)
            return out
        tr.renderer.render_image = spy
        try:
            return tr.render_eval(state, 7, batch)
        finally:
            del tr.renderer.render_image

    def check(a, b):
        gap = (frames[a][0] - frames[b][0]).abs().max().item()
        return gap <= RGB_TOL and psnr(frames[a][0], frames[b][0]).item() >= PSNR_MIN

    render(evaler, "kernel_before")
    render(trainer, "xla_before")
    assert check("kernel_before", "xla_before")
    assert frames["xla_before"][0].max() > 0.05
    trainer.train_step(state, batch, torch.Generator().manual_seed(1))
    metrics = render(evaler, "kernel_after")
    render(trainer, "xla_after")
    assert np.isfinite(metrics["eval_psnr"])
    assert not check("kernel_after", "kernel_before")   # the weights moved
    assert check("kernel_after", "xla_after")
