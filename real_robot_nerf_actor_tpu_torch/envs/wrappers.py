"""Environment wrappers and the make_env factory (counterpart of the JAX
package's `envs/wrappers.py`).

The reference system's make_env stacks TimeLimit, Success,
ObservationSpace, ActionSpace, FrameStack, DynamicCamera,
DomainRandomization, CameraPos and Gripper wrappers over the robot suite;
here on gymnasium with the raycast renderer. `EmbeddingWrapper` runs the
port's `models.representations.Embedding` (a torch module on its device)
on each stacked frame. Needs `mujoco` and `gymnasium`.
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

import numpy as np

from real_robot_nerf_actor_tpu_torch.envs._deps import require
from real_robot_nerf_actor_tpu_torch.envs.base import XArmSimEnv

gym = require("gymnasium")


class SuccessWrapper(gym.Wrapper):
    """Tracks episode success (any step with info['success'])."""

    def reset(self, **kw):
        self._success = False
        return self.env.reset(**kw)

    def step(self, action):
        obs, r, term, trunc, info = self.env.step(action)
        self._success = self._success or bool(info.get("success", False))
        info["episode_success"] = self._success
        return obs, r, term, trunc, info


class ActionSpaceWrapper(gym.ActionWrapper):
    """Restrict the Cartesian action space: 'xy', 'xyz', or 'xyzw' (full)."""

    def __init__(self, env, mode: str = "xyzw"):
        super().__init__(env)
        self.mode = mode
        dims = {"xy": 2, "xyz": 3, "xyzw": 4}[mode]
        self.action_space = gym.spaces.Box(-1.0, 1.0, (dims,), np.float32)

    def action(self, a):
        a = np.asarray(a, np.float32)
        full = np.zeros(4, np.float32)
        if self.mode == "xy":
            full[:2] = a
            full[3] = 1.0  # keep gripper closed
        elif self.mode == "xyz":
            full[:3] = a
            full[3] = 1.0
        else:
            full[:] = a
        return full


class FrameStackWrapper(gym.Wrapper):
    """Stack the last k image observations along the channel axis."""

    def __init__(self, env, k: int = 3):
        super().__init__(env)
        self.k = k
        self._frames: deque = deque(maxlen=k)
        space = env.observation_space
        assert isinstance(space, gym.spaces.Box) and len(space.shape) == 3
        h, w, c = space.shape
        self.observation_space = gym.spaces.Box(0.0, 1.0, (h, w, c * k),
                                                np.float32)

    def reset(self, **kw):
        obs, info = self.env.reset(**kw)
        for _ in range(self.k):
            self._frames.append(obs)
        return self._obs(), info

    def step(self, action):
        obs, r, term, trunc, info = self.env.step(action)
        self._frames.append(obs)
        return self._obs(), r, term, trunc, info

    def _obs(self):
        return np.concatenate(list(self._frames), axis=-1)


class DynamicCameraWrapper(gym.Wrapper):
    """Moves the 'dynamic' camera along an orbit each step — the multi-view
    NeRF data collection trajectory (reference DynamicCameraWrapper)."""

    def __init__(self, env, radius: float = 0.8, height: float = 0.55,
                 n_steps: int = 24, center=(0.0, 0.0, 0.1)):
        super().__init__(env)
        self.radius = radius
        self.height = height
        self.n_steps = n_steps
        self.center = np.asarray(center)
        self._t = 0

    def _place(self):
        ang = 2 * np.pi * (self._t % self.n_steps) / self.n_steps
        eye = self.center + np.array([self.radius * np.cos(ang),
                                      self.radius * np.sin(ang), self.height])
        fwd = self.center - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        base = self.env.unwrapped
        base.set_camera_pose("dynamic", eye,
                             xyaxes=np.concatenate([right, up]))

    def reset(self, **kw):
        self._t = 0
        self._place()
        return self.env.reset(**kw)

    def step(self, action):
        self._t += 1
        self._place()
        return self.env.step(action)


class DomainRandomizationWrapper(gym.Wrapper):
    """Randomizes geom colors (except the robot) on every reset."""

    def __init__(self, env, seed: int = 0, strength: float = 0.15):
        super().__init__(env)
        self._rng = np.random.default_rng(seed)
        self.strength = strength
        base = env.unwrapped
        self._base_rgba = base.model.geom_rgba.copy()

    def reset(self, **kw):
        base = self.env.unwrapped
        noise = self._rng.uniform(-self.strength, self.strength,
                                  self._base_rgba[:, :3].shape)
        base.model.geom_rgba[:, :3] = np.clip(
            self._base_rgba[:, :3] + noise, 0.05, 1.0)
        return self.env.reset(**kw)


class CameraPosWrapper(gym.Wrapper):
    """Exposes camera intrinsics/extrinsics/focal in info (reference
    CameraPosWrapper getters)."""

    def __init__(self, env, cam: str = "front"):
        super().__init__(env)
        self.cam = cam

    def _cam_info(self):
        base = self.env.unwrapped
        k = base.camera_intrinsic(self.cam)
        return {"cam_extrinsic": base.camera_extrinsic(self.cam),
                "cam_intrinsic": k, "focal": float(k[0, 0])}

    def reset(self, **kw):
        obs, info = self.env.reset(**kw)
        info.update(self._cam_info())
        return obs, info

    def step(self, action):
        obs, r, term, trunc, info = self.env.step(action)
        info.update(self._cam_info())
        return obs, r, term, trunc, info


class GripperWrapper(gym.Wrapper):
    """Adds the scalar gripper state to info each step."""

    def step(self, action):
        obs, r, term, trunc, info = self.env.step(action)
        info["gripper_open"] = self.env.unwrapped.gripper_open()
        return obs, r, term, trunc, info


def make_env(domain_name: str = "robot", task_name: str = "reach",
             obs_mode: str = "state", image_size: int = 64,
             episode_length: int = 50, action_space: str = "xyzw",
             frame_stack: int = 1, dynamic_camera: bool = False,
             domain_randomization: bool = False, camera_info: bool = False,
             cameras: Sequence[str] = ("front",), seed: int = 0,
             embedding=None, embedding_variables=None) -> gym.Env:
    """Compose the wrapper stack (reference make_env, wrappers.py:22-118).

    domain_name: 'robot' (the bundled xArm suite), 'metaworld', or 'dmc' —
    the latter two mirror the reference's branches and require the
    respective package to be installed (neither is vendored here; the
    reference vendors ~17k LoC of metaworld instead).
    embedding (+ embedding_variables, here the torch module it applies):
    optional frozen-encoder EmbeddingWrapper, the reference's
    embedding_model argument.
    """
    if domain_name == "metaworld":
        env = _make_metaworld(task_name, seed)
    elif domain_name == "dmc":
        env = _make_dmc(task_name, seed)
    elif domain_name == "robot":
        env = XArmSimEnv(task_name=task_name, obs_mode=obs_mode,
                         image_size=image_size, cameras=cameras, seed=seed)
    else:
        raise ValueError(f"unknown domain {domain_name!r}")
    if domain_name != "robot":
        if embedding is not None:
            env = EmbeddingWrapper(env, embedding, embedding_variables)
        if frame_stack > 1:
            env = FrameStackWrapper(env, frame_stack)
        return gym.wrappers.TimeLimit(env, max_episode_steps=episode_length)
    env = SuccessWrapper(env)
    env = ActionSpaceWrapper(env, action_space)
    if dynamic_camera:
        env = DynamicCameraWrapper(env)
    if domain_randomization:
        env = DomainRandomizationWrapper(env, seed=seed)
    if camera_info:
        env = CameraPosWrapper(env)
    env = GripperWrapper(env)
    if embedding is not None:
        env = EmbeddingWrapper(env, embedding, embedding_variables)
    if frame_stack > 1 and obs_mode == "image":
        env = FrameStackWrapper(env, frame_stack)
    env = gym.wrappers.TimeLimit(env, max_episode_steps=episode_length)
    return env


class LegacyGymAdapter(gym.Env):
    """Old-gym (4-tuple step, obs-only reset) -> gymnasium API.

    metaworld's V2 envs speak the pre-gymnasium protocol (the reference
    vendors old gym alongside them); this adapter lets them flow through
    the same gymnasium wrapper stack as the native suite."""

    def __init__(self, env):
        self.env = env
        self.action_space = _as_gymnasium_box(env.action_space)
        self.observation_space = _as_gymnasium_box(env.observation_space)

    def reset(self, *, seed=None, options=None):
        if seed is not None and hasattr(self.env, "seed"):
            self.env.seed(seed)
        out = self.env.reset()
        if isinstance(out, tuple) and len(out) == 2:
            return out
        return out, {}

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        return obs, reward, bool(done), False, info

    def render(self):
        return self.env.render()


class DmcGymAdapter(gym.Env):
    """dm_env (TimeStep protocol) -> gymnasium, flattened state obs.

    Reference analog: src/env/wrappers.py:105-116 DMCWrapper — the
    dm_control suite env is adapted to the gym API before the common
    wrapper tail (FrameStack etc.)."""

    def __init__(self, env, seed: int = 0):
        self.env = env
        spec = env.action_spec()
        self.action_space = gym.spaces.Box(
            np.asarray(spec.minimum, np.float32),
            np.asarray(spec.maximum, np.float32),
            shape=tuple(spec.shape), dtype=np.float32)
        dim = int(sum(np.prod(s.shape) if s.shape else 1
                      for s in env.observation_spec().values()))
        self.observation_space = gym.spaces.Box(
            -np.inf, np.inf, (dim,), np.float32)

    @staticmethod
    def _flatten(obs_dict):
        return np.concatenate([np.asarray(v, np.float32).reshape(-1)
                               for v in obs_dict.values()])

    def reset(self, *, seed=None, options=None):
        ts = self.env.reset()
        return self._flatten(ts.observation), {}

    def step(self, action):
        ts = self.env.step(action)
        done = bool(ts.last())
        return (self._flatten(ts.observation), float(ts.reward or 0.0),
                done, False, {})


def _as_gymnasium_box(space):
    """Rebuild a (possibly old-gym) Box space as a gymnasium Box."""
    import numpy as np
    if isinstance(space, gym.spaces.Box):
        return space
    return gym.spaces.Box(np.asarray(space.low), np.asarray(space.high),
                          dtype=space.dtype)


def _make_metaworld(task_name: str, seed: int):
    """Reference wrappers.py:86-102: metaworld goal-hidden V2 env."""
    try:
        from metaworld.envs import (  # type: ignore
            ALL_V2_ENVIRONMENTS_GOAL_HIDDEN)
    except ImportError as e:
        raise ImportError(
            "domain 'metaworld' requires the metaworld package (the "
            "reference vendors it; this build uses the installed one)"
        ) from e
    env = ALL_V2_ENVIRONMENTS_GOAL_HIDDEN[f"{task_name}-v2-goal-hidden"]()
    env.seed(seed)
    return LegacyGymAdapter(env)


def _make_dmc(task_name: str, seed: int):
    """Reference wrappers.py:104-116: dm_control suite env, adapted to
    gymnasium before the wrapper tail."""
    try:
        from dm_control import suite  # type: ignore
    except ImportError as e:
        raise ImportError(
            "domain 'dmc' requires dm_control to be installed") from e
    domain, task = task_name.replace("-", "_").split("_", 1)
    return DmcGymAdapter(suite.load(domain, task,
                                    task_kwargs={"random": seed},
                                    visualize_reward=False), seed)


class ObservationSpaceWrapper(gym.Wrapper):
    """Normalize observations to a chosen modality (reference
    wrappers.py:371-420: image/state/state+image selection with the state
    returned alongside).

    obs_mode 'state+image' yields (image, state) tuples; 'image'/'state'
    pass through the respective array. The underlying env must expose
    `render_state()` (our XArmSimEnv does via obs_mode switching) or emit
    dict observations.
    """

    def __init__(self, env, observation_type: str = "image"):
        super().__init__(env)
        self.observation_type = observation_type

    def _convert(self, obs):
        if isinstance(obs, dict):
            if self.observation_type == "state+image":
                return obs["image"], obs.get("state")
            return obs[self.observation_type.replace("state+", "")]
        return obs

    def reset(self, **kw):
        obs, info = self.env.reset(**kw)
        return self._convert(obs), info

    def step(self, action):
        obs, r, term, trunc, info = self.env.step(action)
        return self._convert(obs), r, term, trunc, info


class EmbeddingWrapper(gym.Wrapper):
    """Replace image observations with a frozen encoder's features (the
    reference's embedding wrapper: each stacked frame passes through the
    embedding separately, under inference_mode; the features are
    concatenated).

    embedding: a `models.representations.Embedding`; module: the torch
    module it applies (the one `embedding.init` returned, or one holding
    converted pretrained weights), on the embedding's device; None applies
    the embedding's own (the parameter-free `zero` and `state` have none).
    """

    def __init__(self, env, embedding, module=None):
        super().__init__(env)
        self.embedding = embedding
        self.module = module if module is not None else embedding.module

    def _features(self, frame):
        import torch

        from real_robot_nerf_actor_tpu_torch.models.representations import to_tensors
        with torch.inference_mode():
            if self.module is None:
                out = self.embedding(frame)
            else:
                out = self.module(to_tensors(frame, self.embedding.device))
        return out[0].float().cpu().numpy()

    def _embed(self, obs):
        arr = np.asarray(obs)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        n_frames = max(arr.shape[-1] // 3, 1)
        return np.concatenate([self._features(arr[None, ..., 3 * i:3 * (i + 1)])
                               for i in range(n_frames)], -1)

    def reset(self, **kw):
        obs, info = self.env.reset(**kw)
        return self._embed(obs), info

    def step(self, action):
        obs, r, term, trunc, info = self.env.step(action)
        return self._embed(obs), r, term, trunc, info
