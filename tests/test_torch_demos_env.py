"""The env half of the port's data/demos.py and tools/gen_data.py against the
JAX package's (same MuJoCo): the scripted expert on every task, expert
demonstrations in state and point-cloud observations and the orbit NeRF
scenes equal bit for bit; `gen_data demos` and `nerf` write the files the
JAX script writes, array for array; regenerating tests/fixtures/mujoco_xarm
from its manifest's commands reproduces every digest in it; BCTrainer.evaluate
runs on the port's env; and the JAX and port BC policies (the JAX weights
converted) act alike on an observation sequence recorded from the JAX env;
and the fixture's episodes go through the PerAct step in float64.

Tolerances: bit for bit, except the BC actions (the zoo's fp32 1e-5 of the
actions' scale) and the float64 step against the fp32 one (1e-3 of each
gradient's scale).
"""
import json
import os
import pathlib
import runpy
import sys

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")
pytest.importorskip("gymnasium")

from real_robot_nerf_actor_tpu.data import demos as jdemos  # noqa: E402
from real_robot_nerf_actor_tpu.envs import base as jbase  # noqa: E402
from real_robot_nerf_actor_tpu_torch.data import demos as tdemos  # noqa: E402
from real_robot_nerf_actor_tpu_torch.envs import base as tbase  # noqa: E402
from real_robot_nerf_actor_tpu_torch.tools import gen_data  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "mujoco_xarm"


def _trajs_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.success == y.success
        for f in ("actions", "rewards", "gripper_open", "ee_positions"):
            assert np.array_equal(np.asarray(getattr(x, f)), np.asarray(getattr(y, f))), f
        assert len(x.observations) == len(y.observations)
        for o, p in zip(x.observations, y.observations):
            if isinstance(o, dict):
                assert set(o) == set(p) and all(np.array_equal(o[k], p[k]) for k in o)
            else:
                assert np.array_equal(o, p)


@pytest.mark.parametrize("task", sorted(jbase.TASK_REGISTRY))
def test_scripted_expert_matches_jax(task):
    """The expert drives both envs for 60 steps (hold latches and all):
    every action and state equal bit for bit."""
    ej, et = jbase.XArmSimEnv(task, seed=0), tbase.XArmSimEnv(task, seed=0)
    oj, ot = ej.reset(seed=2)[0], et.reset(seed=2)[0]
    for _ in range(60):
        aj, at = jdemos.scripted_expert(ej), tdemos.scripted_expert(et)
        assert np.array_equal(np.asarray(aj), np.asarray(at))
        oj, rj, _, _, ij = ej.step(aj)
        ot, rt, _, _, it = et.step(at)
        assert np.array_equal(oj, ot) and rj == rt and ij == it


@pytest.mark.parametrize("obs_mode", ["state", "pointcloud"])
def test_generate_demonstrations_matches_jax(obs_mode):
    kw = dict(task_name="push", n_demos=2, obs_mode=obs_mode, image_size=16,
              episode_length=30, seed=1, keep_failures=True)
    _trajs_equal(jdemos.generate_demonstrations(**kw), tdemos.generate_demonstrations(**kw))


def test_generate_nerf_scene_matches_jax():
    kw = dict(task_name="pick_place", n_views=5, image_size=20, seed=3, n_random_steps=2)
    a, b = jdemos.generate_nerf_scene(**kw), tdemos.generate_nerf_scene(**kw)
    for f in ("images", "poses", "depth"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.focal == b.focal and b.features is None


def _arrays(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with np.load(os.path.join(d, name)) as z:
            out[name] = {k: z[k] for k in z.files}
    return out


@pytest.mark.parametrize("argv", [["demos", "--task", "lift", "--n", "2", "--seed", "1"],
                                  ["nerf", "--task", "push", "--n", "2", "--views", "4",
                                   "--image-size", "16", "--seed", "2"]], ids=["demos", "nerf"])
def test_gen_data_writes_the_jax_scripts_files(argv, tmp_path, monkeypatch):
    jout, tout = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["gen_data.py", *argv, "--out", str(jout)])
    runpy.run_path(str(REPO / "scripts" / "gen_data.py"), run_name="__main__")
    gen_data.main([*argv, "--out", str(tout)])
    want, got = _arrays(jout), _arrays(tout)
    assert sorted(got) == sorted(want) and want
    for name in want:
        assert sorted(got[name]) == sorted(want[name]), name
        for k, v in want[name].items():
            assert got[name][k].dtype == v.dtype and np.array_equal(got[name][k], v), (name, k)


def test_fixture_regenerates_to_its_manifest(tmp_path):
    """The committed fixture: at most 2 MB; its manifest's commands, run
    again, write the same files with the same digests (npz_digest)."""
    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    files = sorted(p.name for p in FIXTURE.glob("*.npz"))
    assert files == sorted(manifest["sha256"])
    assert sum(p.stat().st_size for p in FIXTURE.iterdir()) <= 2 * 2 ** 20
    for name in files:
        assert gen_data.npz_digest(str(FIXTURE / name)) == manifest["sha256"][name], name
    for cmd in manifest["commands"]:
        gen_data.main([*cmd, "--out", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == files
    for name in files:
        assert gen_data.npz_digest(str(tmp_path / name)) == manifest["sha256"][name], name


def test_bc_on_the_ports_env_and_actions_match_jax():
    """BCTrainer.evaluate runs on the port's env; on an image sequence
    recorded from the JAX env (the JAX policy acting), the port's policy
    with the JAX weights gives the JAX actions."""
    import jax

    from real_robot_nerf_actor_tpu.train import bc as jbc
    from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
    from real_robot_nerf_actor_tpu_torch.train import bc as tbc

    env = tbase.XArmSimEnv("reach", obs_mode="state")
    state_bc = tbc.BCTrainer(tbc.BCConfig(embedding="state", hidden_dim=16),
                             env.reset(seed=0)[0], device="cpu")
    rate = state_bc.evaluate(env, n_episodes=2, max_steps=5)
    assert rate in (0.0, 0.5, 1.0)

    jenv = jbase.XArmSimEnv("lift", obs_mode="image", image_size=16)
    obs = jenv.reset(seed=4)[0]
    kw = dict(embedding="simple", hidden_dim=32)
    jtr = jbc.BCTrainer(jbc.BCConfig(**kw), obs, seed=0)
    ttr = tbc.BCTrainer(tbc.BCConfig(**kw), obs, seed=0, device="cpu")
    ttr.encoder.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                          jtr.enc_vars)))
    ttr.policy.load_state_dict(flax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jtr.pol_params)}))
    seq = [obs]
    for _ in range(5):
        seq.append(jenv.step(jtr.act(seq[-1]))[0])
    want = np.stack([np.asarray(jtr.act(o)) for o in seq])
    got = np.stack([ttr.act(o) for o in seq])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_float64_peract_step_on_the_fixture_episodes():
    """The fixture's first keyframe pair through EpisodeDataset into the
    PerAct step with compute_dtype "float64" (weights .double()): every
    module's float outputs and every gradient float64 (no fp32 op left on
    the way: the fp32 heads follow the network's dtype), and every gradient
    within 1e-3 of its scale of the fp32 step's (the same function;
    trans_decoder.bias, which no loss moves beyond rounding, aside)."""
    import dataclasses

    import torch

    from real_robot_nerf_actor_tpu_torch.data.episodes import EpisodeDataset, load_trajectory
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig, PerActTrainer
    from real_robot_nerf_actor_tpu_torch.utils.config import from_dict

    bounds = [-0.1, -0.3, -0.2, 0.8, 0.7, 0.7]
    cfg = from_dict(PerActConfig, dict(
        model=dict(depth=1, voxel_size=10, num_latents=16, latent_dim=32, im_channels=8,
                   cross_dim_head=8, latent_dim_head=8, latent_heads=2, voxel_patch_size=5,
                   final_dim=8), voxelizer=dict(voxel_size=10, max_num_coords=800),
        coord_bounds=bounds))
    trajs = [load_trajectory(str(p)) for p in sorted(FIXTURE.glob("ep_*.npz"))]
    host = EpisodeDataset(trajs, bounds, voxel_size=10, max_num_coords=800).get(0)

    def grads(dtype):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype))
        tr = PerActTrainer(c, device="cpu")
        state = tr.init_state(torch.Generator().manual_seed(0))
        wide = torch.float64 if dtype == "float64" else torch.float32
        state.module.to(wide)
        seen = set()
        for module in state.module.modules():
            module.register_forward_hook(lambda m, i, o: seen.update(
                t.dtype for t in (o if isinstance(o, tuple) else (o,)) if t.is_floating_point()))
        batch = {k: torch.as_tensor(v[None]) for k, v in host.items()}
        batch = {k: v.to(wide) if v.is_floating_point() else v for k, v in batch.items()}
        tr.train_step(state, batch, draws=torch.tensor([[0.37, -0.61, 0.18]], dtype=wide))
        return seen, {n: p.grad for n, p in state.module.named_parameters()
                      if not n.endswith("trans_decoder.bias")}

    (seen64, g64), (seen32, g32) = grads("float64"), grads("float32")
    assert seen64 == {torch.float64} and seen32 == {torch.float32}
    assert {g.dtype for g in g64.values()} == {torch.float64}
    assert g64["input_preprocess.Conv_0.bias"].abs().max() > 0
    for n, g in g64.items():
        assert (g - g32[n].double()).abs().max().item() <= 1e-3 * g.abs().max().item(), n
