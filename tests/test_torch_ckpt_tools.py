"""The port's tools that read a trained checkpoint against the JAX scripts
run in-process at the tiny joint config (sys.argv patched; nothing of the
JAX package changes): `tools/eval_quality.py` (the plain-field variants),
`tools/analyze_bc.py` and `tools/extract_nerf_feat.py`, on a kitchen the
port writes (its writer equals the JAX package's) and one set of weights
(numpy draws in the flax tree, saved by each package's CheckpointManager;
the port's converted by convert.joint_to_state_dict). The port's draws
seams are fed the JAX keys' draws. Also the serve entry point's
--ckpt-dir and tools/profile_policy.py's knobs (ROADMAP §3 items 1 and 3).

Tolerances: BC decodes equal (argmax of the same fp32 logits); fp32 PSNRs
1e-3 dB and the point cloud's points 1e-5 (fp32 sums in another order);
the bf16 frame's PSNRs 0.05 dB and its mean |rgb gap| to the fp32 frame
2^-8 (the two packages round bf16 at other places, and one sample's density
one bf16 ulp apart moves a pixel by up to 0.04: its largest gap is not
compared); served logits equal bit for bit.
"""
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu_torch.convert import joint_to_state_dict
from real_robot_nerf_actor_tpu_torch.data.kitchen import write_kitchen_demos
from real_robot_nerf_actor_tpu_torch.tools import analyze_bc, eval_quality, extract_nerf_feat
from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActTrainer
from real_robot_nerf_actor_tpu_torch.train.trainer import CheckpointManager
from tests.test_torch_train_nerfact import FIELD, MODEL, _configs, _numpy_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 16
RENDER = dict(image_width=HW, image_height=HW, n_coarse=6, n_fine=4, n_fine_depth=2,
              ray_chunk_size=8)
N_POINTS = 3000


def _overrides():
    out = [f"peract.model.{k}={v}" for k, v in MODEL.items()
           if k not in ("input_encoder", "return_voxel_feat")]
    out += ["peract.voxelizer.voxel_size=10", f"peract.voxelizer.max_num_coords={N_POINTS}"]
    out += [f"renderer.{k}={v}" for k, v in RENDER.items()]
    out += [f"renderer.field.{k}={v}" for k, v in FIELD.items() if k != "coord_bounds"]
    sum_o = []
    for o in out:
        sum_o += ["-o", o]
    return sum_o


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    _script(name).main()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A 2-demo kitchen of 16 x 16 views and one set of weights in both
    packages' checkpoints (step 3)."""
    from real_robot_nerf_actor_tpu.train.nerfact import NerfActTrainer as JaxTrainer
    from real_robot_nerf_actor_tpu.train.trainer import CheckpointManager as JaxCkpt
    from real_robot_nerf_actor_tpu.train.trainer import TrainState as JaxState

    d = tmp_path_factory.mktemp("ckpt_tools")
    write_kitchen_demos(str(d / "kitchen"), n_demos=2, n_keyframes=3, image_hw=(HW, HW),
                        focal=76.18 * HW / 80.0, d_embed=FIELD["d_embed"],
                        n_points=N_POINTS)
    jax_cfg, cfg = _configs(**RENDER)
    jtr = JaxTrainer(jax_cfg)
    params, extra = _numpy_state(jtr)
    st = jtr.init_state(jax.random.key(0))
    JaxCkpt(str(d / "jax")).save(3, JaxState(step=jax.numpy.asarray(3, jax.numpy.int32),
                                             params=params, opt_state=st.opt_state,
                                             extra=extra))
    tr = NerfActTrainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    state.module.load_state_dict(joint_to_state_dict(jax.device_get(params),
                                                     jax.device_get(extra)))
    state.step = 3
    CheckpointManager(str(d / "port")).save(3, state)
    return dict(dir=d, jax_cfg=jax_cfg, cfg=cfg)


def _tile_draws(rc, key):
    """JAX render_image's draws of one tile of the whole frame (key order
    of its render_rays)."""
    kk = jax.random.split(key, 1)[0]
    k_coarse, k_fine, k_fdepth, _, _ = jax.random.split(kk, 5)
    k_u, k_j = jax.random.split(k_fine)
    r, nf = rc.image_width * rc.image_height, rc.n_fine - rc.n_fine_depth
    d = {"coarse_u": jax.random.uniform(k_coarse, (r, rc.n_coarse)),
         "fine_u": jax.random.uniform(k_u, (r, nf)),
         "fine_jitter": jax.random.uniform(k_j, (r, nf)),
         "fine_depth_eps": jax.random.normal(k_fdepth, (r, rc.n_fine_depth))}
    return [{k: torch.from_numpy(np.array(v)) for k, v in d.items()}]


def test_eval_quality_matches_the_script(ckpts, monkeypatch, tmp_path):
    """Both plain-field variants and the BC decode (with one SE(3)-shifted
    decode a transition), the port fed the script's keys' draws."""
    d = ckpts["dir"]
    common = _overrides() + ["--data-root", str(d / "kitchen"), "--n-demos", "2",
                             "--holdout-demos", "1", "--n-perturb", "1",
                             "--variants", "xla_fp32,xla_bf16"]
    _run_script(monkeypatch, "eval_quality",
                common + ["--ckpt-dir", str(d / "jax"), "--out", str(tmp_path / "jax.json")])
    want = json.load(open(tmp_path / "jax.json"))
    monkeypatch.setattr(eval_quality, "frame_draws",
                        lambda name, rend, plan, pose: _tile_draws(rend.cfg, jax.random.key(7)))
    monkeypatch.setattr(eval_quality, "perturb_draws", lambda dd, k, p: torch.from_numpy(
        np.array(jax.random.uniform(jax.random.key(1000 * dd + 10 * k + p), (3,),
                                    minval=-1.0, maxval=1.0))))
    got = eval_quality.main(common + ["--ckpt-dir", str(d / "port"), "--device", "cpu",
                                      "--out", str(tmp_path / "port.json")])
    assert got == json.load(open(tmp_path / "port.json"))
    assert set(got) == set(want) and got["step"] == want["step"] == 3
    for k in ("bc", "bc_holdout_demo", "bc_se3_perturbed"):
        assert got[k] == want[k], k
    assert set(got["xla_fp32"]) == set(want["xla_fp32"])
    for k, w in want["xla_fp32"].items():
        assert abs(got["xla_fp32"][k] - w) <= 1e-3, k
    assert set(got["xla_bf16"]) == set(want["xla_bf16"])
    for k, w in want["xla_bf16"].items():
        if k.startswith("psnr"):
            assert abs(got["xla_bf16"][k] - w) <= 0.05, (k, got["xla_bf16"][k], w)
    assert abs(got["xla_bf16"]["mean_drgb_vs_fp32"] - want["xla_bf16"]["mean_drgb_vs_fp32"]) \
        <= 2 ** -8


def test_eval_quality_lists_the_scripts_variants():
    """Every serving variant of the script, in its order, with its
    overrides; the port's RendererConfig of each."""
    src = open(os.path.join(REPO, "scripts", "eval_quality.py")).read()
    names = [line.split('"')[1] for line in src.splitlines()
             if line.strip().startswith('variant("')]
    assert [n for n, _ in eval_quality.VARIANTS] == names
    cfg = _configs(**RENDER)[1].renderer
    rc = eval_quality.variant_config(cfg, dict(eval_quality.VARIANTS)["occ_int8_cull16sgf"])
    assert rc.use_ray_plan and rc.n_coarse == 16 and rc.field.gather_fused_mlp
    assert rc.field.int8_static_act and rc.field.mlp_backend == "pallas_int8"


def test_analyze_bc_matches_the_script(ckpts, monkeypatch, capsys):
    d = ckpts["dir"]
    common = _overrides() + ["--data-root", str(d / "kitchen"), "--n-demos", "2"]
    _run_script(monkeypatch, "analyze_bc", common + ["--ckpt-dir", str(d / "jax")])
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("d")]
    got = analyze_bc.main(common + ["--ckpt-dir", str(d / "port"), "--device", "cpu"])
    assert "checkpoint step 3" in capsys.readouterr().out
    assert len(want) == 4 and got == want


def test_extract_nerf_feat_matches_the_script(ckpts, monkeypatch, tmp_path):
    """The script takes NerfActConfig's defaults: here the tiny config
    (patched into the JAX package's module namespace, as the script reads
    it); the port's samples take the script's key's draws."""
    import real_robot_nerf_actor_tpu.train as jtrain
    d = ckpts["dir"]
    monkeypatch.setattr(jtrain, "NerfActConfig", lambda: ckpts["jax_cfg"])
    argv = ["--target-min", "50", "--target-max", "300"]
    _run_script(monkeypatch, "extract_nerf_feat",
                argv + ["--ckpt-dir", str(d / "jax"), "--out", str(tmp_path / "jax.npz")])
    want = np.load(tmp_path / "jax.npz")
    monkeypatch.setattr(extract_nerf_feat, "coarse_draws", lambda shape, device: torch.from_numpy(
        np.array(jax.random.uniform(jax.random.key(2), shape))))
    res = extract_nerf_feat.main(argv + _overrides() + [
        "--ckpt-dir", str(d / "port"), "--device", "cpu", "--out", str(tmp_path / "port.npz")])
    got = np.load(tmp_path / "port.npz")
    assert set(got.files) == set(want.files) and 50 <= res["points"].shape[0] <= 300
    np.testing.assert_allclose(float(got["threshold"]), float(want["threshold"]), rtol=1e-5)
    assert got["points"].shape == want["points"].shape
    for k in ("points", "rgbs", "sigmas", "embeds"):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want[k]).max()), err_msg=k)


# -------------------------------------------------- serve a trained policy
def test_serve_restores_a_trained_policy(tmp_path, capsys):
    """ROADMAP §3 item 1: a tiny PerAct step trained on the CPU and saved,
    then served through the entry point's --ckpt-dir: the served logits
    equal the trained module's bit for bit, and main prints the step."""
    from real_robot_nerf_actor_tpu_torch.train import serve
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActTrainer
    from tests.test_torch_train_peract import TINY, _batch
    from tests.test_torch_train_peract import _configs as peract_configs

    cfg = peract_configs()[1]
    tr = PerActTrainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    state, _ = tr.train_step(state, batch, torch.Generator().manual_seed(1))
    CheckpointManager(str(tmp_path)).save(1, state)
    argv = ["--ckpt-dir", str(tmp_path), "--device", "cpu", "--steps", "1",
            "-o", "voxelizer.voxel_size=10", "-o", "voxelizer.max_num_coords=2000"]
    argv += sum((["-o", f"model.{k}={v}"] for k, v in TINY.items()), [])
    server, _, _ = serve.build_server(argv)
    assert "restored step 1" in capsys.readouterr().out
    net = state.module.eval()
    rng = np.random.default_rng(0)
    vox = torch.from_numpy(rng.standard_normal((1, 10, 10, 10, 10)).astype(np.float32))
    proprio = torch.tensor([[3.0, 4.0, 5.0, 30.0, 2.0, 40.0, 1.0]])
    lang = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
    with torch.no_grad():
        for got, want in zip(server.net(vox, proprio, lang), net(vox, proprio, lang)):
            assert torch.equal(got, want)
    trace = serve.main(argv)
    assert len(trace) == 1 and "restored step 1" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no checkpoint"):
        serve.build_server(argv[:1] + [str(tmp_path / "empty")] + argv[2:])


# ------------------------------------------------ tools/profile_policy.py
def test_profile_policy_takes_the_scripts_knobs():
    """ROADMAP §3 item 3: --upsample-mode and --conv-backend override the
    config (after --plain); --pointwise and --shuffle-transpose parse and
    change nothing."""
    from real_robot_nerf_actor_tpu_torch.tools import profile_policy as pp
    args = pp.parse_args(["--upsample-mode", "trilinear", "--conv-backend", "xla",
                          "--pointwise", "--shuffle-transpose"])
    assert args.pointwise and args.shuffle_transpose
    cfg = pp.build_config(args)
    assert cfg.upsample_mode == "trilinear" and cfg.conv_backend == "xla"
    assert cfg.use_flash_attention and cfg.stats_backend == "pallas"
    plain = pp.build_config(pp.parse_args(["--plain", "--conv-backend", "pallas"]))
    assert plain.conv_backend == "pallas" and not plain.use_flash_attention
    base = pp.build_config(pp.parse_args([]))
    assert base == pp.build_config(pp.parse_args(["--pointwise", "--shuffle-transpose"]))
    assert base.conv_backend == "pallas" and base.upsample_mode == "transpose"
