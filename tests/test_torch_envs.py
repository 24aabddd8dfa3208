"""The port's MuJoCo xArm suite (real_robot_nerf_actor_tpu_torch/envs) against
the JAX package's envs, on the same MuJoCo: the MJCF of every task equal
character for character; a seeded action sequence through every task in
every observation mode (16 x 16 images) giving equal observations, rewards,
success and info bit for bit; the camera API; every wrapper of make_env;
the metaworld and dmc branches with injected fake packages (neither package
is installed); EmbeddingWrapper on the port's Embedding with the JAX
embedding's weights converted, within the zoo's fp32 tolerance (1e-5 of the
features' scale); and the ImportError naming mujoco or gymnasium when it
is missing.

Tolerances: bit for bit everywhere but EmbeddingWrapper (1e-5 of scale).
"""
import subprocess
import sys
from collections import OrderedDict

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")
gym = pytest.importorskip("gymnasium")

import real_robot_nerf_actor_tpu.envs.base as jbase  # noqa: E402
import real_robot_nerf_actor_tpu.envs.wrappers as jwr  # noqa: E402
import real_robot_nerf_actor_tpu_torch.envs.base as tbase  # noqa: E402
import real_robot_nerf_actor_tpu_torch.envs.wrappers as twr  # noqa: E402

TASKS = sorted(jbase.TASK_REGISTRY)
MODES = ["state", "image", "depth", "pointcloud"]
STEPS = 4
HW = 16


def _equal(a, b, msg=""):
    """Observations, rewards and infos equal bit for bit (dicts by key)."""
    if isinstance(a, dict):
        assert set(a) == set(b), msg
        for k in a:
            _equal(a[k], b[k], f"{msg}/{k}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), msg
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{msg}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, msg
        assert np.array_equal(a, b, equal_nan=True), msg
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (msg, a, b)


def _rollout_both(make_j, make_t, steps=STEPS, seed=3, action_dim=4):
    ej, et = make_j(), make_t()
    _equal(ej.reset(seed=seed), et.reset(seed=seed), "reset")
    rng = np.random.default_rng(seed)
    for i in range(steps):
        a = rng.uniform(-1, 1, action_dim).astype(np.float32)
        _equal(ej.step(a), et.step(a), f"step {i}")
    return ej, et


def test_task_registry_and_scene_template_match_jax():
    assert sorted(tbase.TASK_REGISTRY) == TASKS and len(TASKS) == 14
    assert tbase._SCENE_TEMPLATE == jbase._SCENE_TEMPLATE
    assert np.array_equal(tbase.WORKSPACE, jbase.WORKSPACE)


@pytest.mark.parametrize("task", TASKS)
def test_task_mjcf_equals_jax(task):
    """The scene MJCF each env compiles is JAX's, character for character."""
    def xml(mod):
        t = mod.TASK_REGISTRY[task]()
        return mod._SCENE_TEMPLATE.format(task=task, objects=t.objects_xml,
                                          extra=t.extra_xml, root=t.root_xml)
    assert xml(tbase) == xml(jbase)
    ej, et = jbase.XArmSimEnv(task), tbase.XArmSimEnv(task)
    for field in ("nq", "nv", "nbody", "ngeom", "njnt", "nmocap", "ncam"):
        assert getattr(ej.model, field) == getattr(et.model, field), field


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("task", TASKS)
def test_rollout_matches_jax(task, mode):
    """A seeded action sequence: observations, rewards, success equal bit
    for bit in each observation mode."""
    cams = ("front", "side") if mode == "pointcloud" else ("front",)
    kw = dict(task_name=task, obs_mode=mode, image_size=HW, cameras=cams, seed=1)
    ej, et = _rollout_both(lambda: jbase.XArmSimEnv(**kw), lambda: tbase.XArmSimEnv(**kw))
    assert et.observation_space == ej.observation_space
    assert np.array_equal(et.render(), ej.render())


def test_camera_api_matches_jax():
    ej, et = jbase.XArmSimEnv("push", obs_mode="image", image_size=HW), \
        tbase.XArmSimEnv("push", obs_mode="image", image_size=HW)
    ej.reset(seed=0)
    et.reset(seed=0)
    for cam in ("front", "side", "top", "dynamic"):
        assert np.array_equal(et.camera_extrinsic(cam), ej.camera_extrinsic(cam))
        assert np.array_equal(et.camera_intrinsic(cam), ej.camera_intrinsic(cam))
    pose = ((0.5, 0.4, 0.6), (0.0, 1.0, 0.0, -0.6, 0.0, 0.8))
    ej.set_camera_pose("dynamic", *pose)
    et.set_camera_pose("dynamic", *pose)
    assert np.array_equal(et.camera_extrinsic("dynamic"), ej.camera_extrinsic("dynamic"))
    from real_robot_nerf_actor_tpu.envs import rendering as jr
    from real_robot_nerf_actor_tpu_torch.envs import rendering as tr
    a = jr.PointCloudGenerator(ej.model, ["front", "top"], HW, HW,
                               bounds=np.array([-0.3, -0.3, 0.0, 0.3, 0.3, 0.4]))
    b = tr.PointCloudGenerator(et.model, ["front", "top"], HW, HW,
                               bounds=np.array([-0.3, -0.3, 0.0, 0.3, 0.3, 0.4]))
    _equal(a.generate(ej.data), b.generate(et.data))
    ra, rb = jr.RaycastRenderer(ej.model, HW, HW), tr.RaycastRenderer(et.model, HW, HW)
    oa, ob = ra.render(ej.data, "dynamic"), rb.render(et.data, "dynamic")
    for f in ("rgb", "depth", "seg"):
        assert np.array_equal(getattr(oa, f), getattr(ob, f)), f


@pytest.mark.parametrize("kw", [
    dict(task_name="lift", obs_mode="image", frame_stack=2, camera_info=True),
    dict(task_name="reach", obs_mode="image", dynamic_camera=True, cameras=("dynamic",)),
    dict(task_name="push", obs_mode="state", domain_randomization=True, seed=4),
    dict(task_name="drawer", obs_mode="state", action_space="xy"),
    dict(task_name="stacking", obs_mode="depth", action_space="xyz"),
], ids=["framestack_caminfo", "dynamic_camera", "domain_randomization", "xy", "xyz_depth"])
def test_make_env_wrappers_match_jax(kw):
    """make_env's stacks (Success, ActionSpace, FrameStack, DynamicCamera,
    DomainRandomization, CameraPos, Gripper, TimeLimit): equal bit for bit
    to the end of the episode."""
    kw = dict(image_size=HW, episode_length=STEPS + 1, **kw)
    dims = {"xy": 2, "xyz": 3}.get(kw.get("action_space"), 4)
    _rollout_both(lambda: jwr.make_env(**kw), lambda: twr.make_env(**kw), steps=STEPS + 1,
                  action_dim=dims)


def test_observation_space_wrapper_matches_jax():
    class DictObs(gym.Env):
        observation_space = gym.spaces.Box(-1, 1, (2,), np.float32)
        action_space = gym.spaces.Box(-1, 1, (1,), np.float32)

        def _obs(self):
            return {"image": np.full((2, 2, 3), 0.5, np.float32), "state": np.ones(2, np.float32)}

        def reset(self, *, seed=None, options=None):
            return self._obs(), {}

        def step(self, a):
            return self._obs(), 0.0, False, False, {}

    for kind in ("image", "state", "state+image"):
        _rollout_both(lambda: jwr.ObservationSpaceWrapper(DictObs(), kind),
                      lambda: twr.ObservationSpaceWrapper(DictObs(), kind), steps=2,
                      action_dim=1)


def test_embedding_wrapper_matches_jax():
    """EmbeddingWrapper over two stacked 16 x 16 frames: the port applies
    its `simple` Embedding module (the JAX entry's weights through
    convert.flax_to_state_dict) to each frame; the features within the
    zoo's 1e-5 of their scale."""
    import jax
    import torch

    from real_robot_nerf_actor_tpu.models import representations as jrep
    from real_robot_nerf_actor_tpu_torch.convert import flax_to_state_dict
    from real_robot_nerf_actor_tpu_torch.models import representations as trep

    jemb, temb = jrep.make_embedding("simple"), trep.make_embedding("simple")
    example = np.zeros((1, HW, HW, 3), np.float32)
    variables = jemb.init(jax.random.key(0), example)
    module = temb.init(example, seed=0, device="cpu")
    module.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables)))
    kw = dict(task_name="lift", obs_mode="image", image_size=HW, frame_stack=1,
              episode_length=4)
    ej = jwr.make_env(embedding=jemb, embedding_variables=variables, **kw)
    et = twr.make_env(embedding=temb, embedding_variables=module, **kw)
    got, want = [et.reset(seed=2)[0]], [ej.reset(seed=2)[0]]
    rng = np.random.default_rng(0)
    for _ in range(3):
        a = rng.uniform(-1, 1, 4).astype(np.float32)
        got.append(et.step(a)[0])
        want.append(ej.step(a)[0])
    # two frames stacked by hand: the wrapper embeds each 3-channel slice
    base_j, base_t = jbase.XArmSimEnv("lift", "image", HW), tbase.XArmSimEnv("lift", "image", HW)
    f0 = base_t.reset(seed=5)[0]
    f1 = base_t.step(np.ones(4, np.float32))[0]
    two = np.concatenate([f0, f1], -1)
    got.append(twr.EmbeddingWrapper(base_t, temb, module)._embed(two))
    want.append(jwr.EmbeddingWrapper(base_j, jemb, variables)._embed(two))
    assert got[-1].shape == (2 * temb.out_dim,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    assert torch.is_grad_enabled()   # the wrapper's inference_mode does not leak


def test_metaworld_branch_with_injected_package(monkeypatch):
    """make_env's metaworld branch: a fake metaworld speaking the old-gym
    protocol goes through LegacyGymAdapter and the wrapper tail; without
    the package the branch raises ImportError as JAX's does."""
    import types

    class FakeMW:
        action_space = gym.spaces.Box(-1, 1, (4,), np.float32)
        observation_space = gym.spaces.Box(-np.inf, np.inf, (39,), np.float32)

        def seed(self, s):
            self._s = s

        def reset(self):
            return np.zeros(39, np.float32)

        def step(self, a):
            return np.zeros(39, np.float32), 1.0, False, {"success": 1.0}

    monkeypatch.setitem(sys.modules, "metaworld", None)
    for mod in (jwr, twr):
        with pytest.raises(ImportError, match="metaworld"):
            mod.make_env(task_name="reach", domain_name="metaworld")
    mw, mw_envs = types.ModuleType("metaworld"), types.ModuleType("metaworld.envs")
    mw_envs.ALL_V2_ENVIRONMENTS_GOAL_HIDDEN = {"reach-v2-goal-hidden": FakeMW}
    mw.envs = mw_envs
    monkeypatch.setitem(sys.modules, "metaworld", mw)
    monkeypatch.setitem(sys.modules, "metaworld.envs", mw_envs)
    kw = dict(task_name="reach", domain_name="metaworld", episode_length=3, seed=1)
    env = twr.make_env(**kw)
    assert isinstance(env.env, twr.LegacyGymAdapter)
    _rollout_both(lambda: jwr.make_env(**kw), lambda: twr.make_env(**kw), steps=3, seed=1)
    assert env.reset(seed=1)[0].shape == (39,)
    assert env.step(np.zeros(4, np.float32))[1] == 1.0


def test_dmc_branch_with_injected_package(monkeypatch):
    """make_env's dmc branch: a fake dm_control suite (dm_env TimeStep
    protocol) through DmcGymAdapter: flattened observations, termination at
    TimeStep.last(); without the package, ImportError as in JAX."""
    import types

    class Spec:
        def __init__(self, shape):
            self.shape = shape
            self.minimum = np.full(shape, -1.0, np.float32)
            self.maximum = np.full(shape, 1.0, np.float32)

    class TS:
        def __init__(self, last=False):
            self.observation = OrderedDict(pos=np.ones(3, np.float32),
                                           vel=np.zeros(2, np.float32))
            self.reward = 0.5
            self._last = last

        def last(self):
            return self._last

    class FakeDmcEnv:
        _n = 0

        def action_spec(self):
            return Spec((2,))

        def observation_spec(self):
            return OrderedDict(pos=Spec((3,)), vel=Spec((2,)))

        def reset(self):
            self._n = 0
            return TS()

        def step(self, a):
            self._n += 1
            return TS(last=self._n >= 2)

    monkeypatch.setitem(sys.modules, "dm_control", None)
    for mod in (jwr, twr):
        with pytest.raises(ImportError, match="dm_control"):
            mod.make_env(task_name="walker-walk", domain_name="dmc")
    dmc, suite = types.ModuleType("dm_control"), types.ModuleType("dm_control.suite")
    suite.load = lambda domain, task, task_kwargs, visualize_reward: FakeDmcEnv()
    dmc.suite = suite
    monkeypatch.setitem(sys.modules, "dm_control", dmc)
    monkeypatch.setitem(sys.modules, "dm_control.suite", suite)
    kw = dict(task_name="walker-walk", domain_name="dmc", episode_length=5, seed=0)
    env = twr.make_env(**kw)
    assert isinstance(env.env, twr.DmcGymAdapter)
    obs, _ = env.reset()
    assert obs.shape == (5,)
    assert not env.step(np.zeros(2, np.float32))[2]
    assert env.step(np.zeros(2, np.float32))[2]
    _rollout_both(lambda: jwr.make_env(**kw), lambda: twr.make_env(**kw), steps=2,
                  action_dim=2)


@pytest.mark.parametrize("hidden", ["mujoco", "gymnasium"])
def test_envs_raise_import_error_naming_the_missing_package(hidden):
    """With mujoco (or gymnasium) unimportable, importing the port's envs
    raises ImportError naming it, and nothing falls back."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] == {hidden!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "try:\n"
        "    import real_robot_nerf_actor_tpu_torch.envs\n"
        "except ImportError as e:\n"
        "    print('raised:', e)\n"
        "else:\n"
        "    print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised:") and repr(hidden) in out.stdout, out.stdout
