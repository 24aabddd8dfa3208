"""The port's act loop against the JAX act loop: the same synthetic replay,
the same (converted) weights, the same packed actions.

Both run fp32 at a tiny width; the decoded actions are discrete (argmax
voxel, rotation bins, grip, collision) and their continuous decode is a
fixed affine map, so they must agree exactly, and the continuous values to
fp32 rounding (1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.data.replay import ReplayRobotIO as JaxRobot
from real_robot_nerf_actor_tpu.data.synthetic import (
    make_replay_steps as jax_replay_steps, make_synthetic_demo as jax_demo,
    make_synthetic_scene as jax_scene)
from real_robot_nerf_actor_tpu.models import PerceiverConfig as JaxConfig
from real_robot_nerf_actor_tpu.models import PerceiverIO as JaxPerceiverIO
from real_robot_nerf_actor_tpu.ops import VoxelizerSpec as JaxSpec
from real_robot_nerf_actor_tpu.train.serve import (
    PolicyServer as JaxServer, ServeConfig as JaxServeConfig,
    run_deployment as jax_run_deployment)
from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
from real_robot_nerf_actor_tpu_torch.data.replay import ReplayRobotIO
from real_robot_nerf_actor_tpu_torch.data.synthetic import (
    make_replay_steps, make_synthetic_demo, make_synthetic_scene)
from real_robot_nerf_actor_tpu_torch.models import PerceiverConfig, PerceiverIO
from real_robot_nerf_actor_tpu_torch.ops import VoxelizerSpec
from real_robot_nerf_actor_tpu_torch.train.serve import (
    PolicyServer, ServeConfig, main, run_deployment, run_deployment_scan)

BOUNDS = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
MODEL = dict(depth=1, voxel_size=10, num_latents=16, latent_dim=32,
             im_channels=8, cross_dim_head=8, latent_dim_head=8, latent_heads=2,
             voxel_patch_size=5, final_dim=8, lang_emb_dim=16,
             lang_max_seq_len=4, num_rotation_classes=72,
             input_encoder="unet")
SPEC = dict(voxel_size=10, feature_size=3, max_num_coords=4000)


@pytest.fixture(scope="module")
def servers():
    jcfg = JaxConfig(**MODEL)
    variables = JaxPerceiverIO(jcfg).init(
        jax.random.key(0), jnp.zeros((1, 10, 10, 10, 10)), jnp.zeros((1, 7)),
        jnp.zeros((1, 4, 16)))
    lang = np.random.default_rng(3).standard_normal((4, 16)).astype(np.float32)
    jserver = JaxServer(JaxServeConfig(coord_bounds=BOUNDS, num_steps=5), jcfg,
                        JaxSpec(**SPEC), variables, lang)
    tserver = PolicyServer(ServeConfig(coord_bounds=BOUNDS, num_steps=5),
                           PerceiverConfig(**MODEL), VoxelizerSpec(**SPEC),
                           flax_to_state_dict(variables), lang, device="cpu")
    return jserver, tserver


def _assert_same_trace(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g["xyz"], w["xyz"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(g["rotation"], w["rotation"], rtol=0, atol=1e-4)
        assert g["gripper_open"] == w["gripper_open"]
        assert g["ignore_collision"] == w["ignore_collision"]


def test_run_deployment_matches_jax(servers):
    jserver, tserver = servers
    jscene = jax_scene(seed=0, n_points=3000)
    jrobot = JaxRobot(jax_replay_steps(jscene, jax_demo(jscene)))
    want = jax_run_deployment(jserver, jrobot)

    scene = make_synthetic_scene(seed=0, n_points=3000)
    np.testing.assert_array_equal(scene.points, jscene.points)
    robot = ReplayRobotIO(make_replay_steps(scene, make_synthetic_demo(scene)))
    got = run_deployment(tserver, robot)
    _assert_same_trace(want, got)
    assert len(robot.commands) == 5


def test_scan_matches_loop_and_replays(servers):
    _, tserver = servers
    scene = make_synthetic_scene(seed=1, n_points=2000)
    steps = make_replay_steps(scene, make_synthetic_demo(scene))
    loop = run_deployment(tserver, ReplayRobotIO(steps))
    robot = ReplayRobotIO(steps)
    scan = run_deployment_scan(tserver, steps, robot=robot)
    _assert_same_trace(loop, scan)
    assert len(robot.commands) == len(steps)


def test_safety_check_aborts(servers):
    _, tserver = servers
    scene = make_synthetic_scene(seed=0, n_points=1000)
    robot = ReplayRobotIO(make_replay_steps(scene, make_synthetic_demo(scene)))
    trace = run_deployment(tserver, robot, safety_check=lambda a, o: False)
    assert len(trace) == 1 and trace[0]["aborted"]
    assert robot.commands == []


def test_serve_main_on_cpu():
    trace = main(["--steps", "2", "--device", "cpu",
                  "-o", "model.voxel_size=10", "-o", "voxelizer.voxel_size=10",
                  "-o", "model.depth=1", "-o", "model.num_latents=8",
                  "-o", "model.latent_dim=32", "-o", "voxelizer.max_num_coords=70000"])
    assert len(trace) == 2
    for a in trace:
        assert (a["xyz"] >= np.array(BOUNDS[:3])).all()
        assert (a["xyz"] <= np.array(BOUNDS[3:])).all()
        assert a["gripper_open"] in (0, 1)


def test_server_casts_the_k3_weight_once():
    """With the conv kernel knob on in bf16, PolicyServer holds `final`'s
    weight in bf16 from load on, so the k3 kernel takes it as it is on
    every call; the forward is the same as with the per-call cast."""
    cfg = PerceiverConfig(**MODEL, compute_dtype="bfloat16",
                          conv_backend="pallas")
    net = PerceiverIO.initialized(cfg, torch.Generator().manual_seed(0)).eval()
    lang = np.random.default_rng(3).standard_normal((4, 16)).astype(np.float32)
    server = PolicyServer(ServeConfig(coord_bounds=BOUNDS), cfg,
                          VoxelizerSpec(**SPEC), net.state_dict(), lang,
                          device="cpu")
    assert net.final.pallas_kernel.dtype == torch.float32
    assert server.net.final.pallas_kernel.dtype == torch.bfloat16
    rng = np.random.default_rng(4)
    vox = torch.from_numpy(rng.standard_normal((1, 10, 10, 10, 10)).astype(np.float32))
    proprio = torch.tensor([[3.0, 4.0, 5.0, 30.0, 2.0, 40.0, 1.0]])
    with torch.no_grad():
        want = net(vox, proprio, server.lang)
        got = server.net(vox, proprio, server.lang)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
