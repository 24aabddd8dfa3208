"""MuJoCo xArm manipulation suite (gymnasium), mocap-Cartesian control
(counterpart of the JAX package's `envs/base.py`).

The reference system's xArm task family (reach, push, lift, pick_place,
peg_in_box, drawer, stacking, shelf_placing, lever_pull, ...) over one
base env with end-effector (mocap) Cartesian control, per-task success
predicates and dense rewards. Tasks are small declarative classes (MJCF
snippet, reset, reward, success) over one `XArmSimEnv`; the scene MJCF is
generated from `_SCENE_TEMPLATE`, the gripper is a mocap-welded
parallel-jaw body, and the observation modes are state / image / depth /
pointcloud through the raycast renderer. Every MJCF string equals the
JAX package's character for character, so physics, rewards and success
equal its envs' bit for bit on the same MuJoCo. Needs `mujoco` and
`gymnasium`: without them importing this module raises ImportError.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Type

import numpy as np

from real_robot_nerf_actor_tpu_torch.envs._deps import require
from real_robot_nerf_actor_tpu_torch.envs.rendering import (
    PointCloudGenerator, RaycastRenderer, camera_intrinsics, camera_pose)

gym = require("gymnasium")
mujoco = require("mujoco")

WORKSPACE = np.array([[-0.35, -0.35, 0.02], [0.35, 0.35, 0.45]])


# --------------------------------------------------------------------- tasks
class Task:
    """Declarative task: object MJCF + reset/reward/success hooks."""

    name = "task"
    objects_xml = ""
    extra_xml = ""
    # task-local <contact>/<equality>-level MJCF appended OUTSIDE
    # <worldbody> (e.g. a contact pair overriding finger-object friction
    # for this task only, leaving every other task's physics untouched)
    root_xml = ""

    def reset(self, model, data, rng: np.random.Generator):
        pass

    def reward(self, env: "XArmSimEnv") -> float:
        return 0.0

    def is_success(self, env: "XArmSimEnv") -> bool:
        return False

    def extra_obs(self, env: "XArmSimEnv") -> Optional[np.ndarray]:
        """Task-specific state-obs entries NOT derivable from qpos/mocap
        (e.g. a goal jittered via model.body_pos / model.site_pos); the
        reference's _get_state_obs always embeds its goal positions."""
        return None

    # helpers
    @staticmethod
    def body_pos(env, name):
        bid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_BODY, name)
        return env.data.xpos[bid].copy()

    @staticmethod
    def set_body_pos(env, name, pos):
        jadr = env.model.body_jntadr[
            mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_BODY, name)]
        qadr = env.model.jnt_qposadr[jadr]
        env.data.qpos[qadr:qadr + 3] = pos


class ReachTask(Task):
    name = "reach"
    objects_xml = """
    <body name="target" pos="0.15 0.1 0.03" mocap="true">
      <geom name="target_geom" type="sphere" size="0.02" rgba="1 0.2 0.2 0.6"
            contype="0" conaffinity="0"/>
    </body>"""

    def reset(self, model, data, rng):
        mid = model.body_mocapid[
            mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_BODY, "target")]
        data.mocap_pos[mid] = rng.uniform([-0.2, -0.2, 0.05], [0.2, 0.2, 0.25])

    def _dist(self, env):
        mid = env.model.body_mocapid[
            mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_BODY, "target")]
        return float(np.linalg.norm(env.ee_pos() - env.data.mocap_pos[mid]))

    def reward(self, env):
        return -self._dist(env)

    def is_success(self, env):
        return self._dist(env) < 0.05


class _ObjectTask(Task):
    """Base for tasks with one free cube object."""

    obj_color = "0.2 0.4 0.9 1"
    objects_xml_template = """
    <body name="object" pos="0.1 0.0 0.045">
      <freejoint name="object_joint"/>
      <geom name="object_geom" type="box" size="0.025 0.025 0.025"
            rgba="{color}" mass="0.1" friction="1.5 0.01 0.0002"/>
    </body>"""

    @property
    def objects_xml(self):
        return self.objects_xml_template.format(color=self.obj_color)

    def reset(self, model, data, rng):
        jadr = model.jnt_qposadr[
            mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_JOINT, "object_joint")]
        data.qpos[jadr:jadr + 3] = [*rng.uniform([-0.15, -0.15], [0.15, 0.15]),
                                    0.045]
        data.qpos[jadr + 3:jadr + 7] = [1, 0, 0, 0]


class PushTask(_ObjectTask):
    name = "push"
    extra_xml = """
    <site name="goal" pos="0.2 0.15 0.03" size="0.02" rgba="0 1 0 0.5"/>"""

    def _goal(self, env):
        sid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_SITE, "goal")
        return env.data.site_xpos[sid].copy()

    def reward(self, env):
        obj = self.body_pos(env, "object")
        return (-np.linalg.norm(obj[:2] - self._goal(env)[:2])
                - 0.5 * np.linalg.norm(env.ee_pos() - obj))

    def is_success(self, env):
        return np.linalg.norm(
            self.body_pos(env, "object")[:2] - self._goal(env)[:2]) < 0.05


class LiftTask(_ObjectTask):
    name = "lift"
    lift_height = 0.15

    def reward(self, env):
        obj = self.body_pos(env, "object")
        reach = -np.linalg.norm(env.ee_pos() - obj)
        return reach + 5.0 * max(0.0, obj[2] - 0.045)

    def is_success(self, env):
        return self.body_pos(env, "object")[2] > self.lift_height


class PickPlaceTask(_ObjectTask):
    name = "pick_place"
    extra_xml = """
    <site name="goal" pos="-0.18 0.15 0.03" size="0.025" rgba="0 1 0 0.5"/>"""

    def _goal(self, env):
        sid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_SITE, "goal")
        return env.data.site_xpos[sid].copy()

    def reward(self, env):
        obj = self.body_pos(env, "object")
        return -np.linalg.norm(obj - self._goal(env)) \
            - 0.5 * np.linalg.norm(env.ee_pos() - obj)

    def is_success(self, env):
        return np.linalg.norm(self.body_pos(env, "object")
                              - self._goal(env)) < 0.06


class PegInBoxTask(_ObjectTask):
    name = "peg_in_box"
    obj_color = "0.9 0.6 0.1 1"
    extra_xml = """
    <body name="box" pos="-0.2 0.12 0.02">
      <geom type="box" size="0.06 0.06 0.005" pos="0 0 0" rgba="0.4 0.25 0.1 1"/>
      <geom type="box" size="0.005 0.06 0.03" pos="0.055 0 0.03" rgba="0.4 0.25 0.1 1"/>
      <geom type="box" size="0.005 0.06 0.03" pos="-0.055 0 0.03" rgba="0.4 0.25 0.1 1"/>
      <geom type="box" size="0.06 0.005 0.03" pos="0 0.055 0.03" rgba="0.4 0.25 0.1 1"/>
      <geom type="box" size="0.06 0.005 0.03" pos="0 -0.055 0.03" rgba="0.4 0.25 0.1 1"/>
    </body>"""

    def is_success(self, env):
        obj = self.body_pos(env, "object")
        box = self.body_pos(env, "box")
        return (np.linalg.norm(obj[:2] - box[:2]) < 0.045
                and obj[2] < box[2] + 0.06)

    def reward(self, env):
        obj = self.body_pos(env, "object")
        box = self.body_pos(env, "box") + [0, 0, 0.03]
        return -np.linalg.norm(obj - box) \
            - 0.5 * np.linalg.norm(env.ee_pos() - obj)


class DrawerTask(Task):
    name = "drawer"
    open_target = 0.12
    extra_xml = """
    <body name="cabinet" pos="-0.25 -0.18 0.06">
      <geom type="box" size="0.07 0.07 0.002" pos="0 0 0.06" rgba="0.5 0.35 0.2 1"/>
      <geom type="box" size="0.002 0.07 0.06" pos="0.068 0 0" rgba="0.5 0.35 0.2 1"/>
      <geom type="box" size="0.002 0.07 0.06" pos="-0.068 0 0" rgba="0.5 0.35 0.2 1"/>
      <geom type="box" size="0.07 0.002 0.06" pos="0 0.068 0" rgba="0.5 0.35 0.2 1"/>
      <body name="drawer" pos="0 -0.01 -0.02">
        <joint name="drawer_slide" type="slide" axis="0 -1 0" range="0 0.15"
               damping="4"/>
        <geom type="box" size="0.06 0.06 0.003" pos="0 0 -0.03" rgba="0.7 0.5 0.3 1"/>
        <geom type="box" size="0.06 0.003 0.03" pos="0 -0.06 0" rgba="0.7 0.5 0.3 1"/>
        <geom name="drawer_handle" type="capsule" size="0.008" fromto="-0.03 -0.075 0 0.03 -0.075 0"
              rgba="0.9 0.9 0.2 1"/>
      </body>
    </body>"""

    def _opening(self, env):
        jid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_JOINT,
                                "drawer_slide")
        return float(env.data.qpos[env.model.jnt_qposadr[jid]])

    def reward(self, env):
        gid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_GEOM,
                                "drawer_handle")
        handle = env.data.geom_xpos[gid]
        return self._opening(env) - 0.2 * np.linalg.norm(env.ee_pos() - handle)

    def is_success(self, env):
        return self._opening(env) > self.open_target


class DrawerCloseTask(DrawerTask):
    name = "drawer_close"

    def reset(self, model, data, rng):
        jid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_JOINT,
                                "drawer_slide")
        data.qpos[model.jnt_qposadr[jid]] = 0.13

    def reward(self, env):
        return -super().reward(env)

    def is_success(self, env):
        return self._opening(env) < 0.02


class StackingTask(_ObjectTask):
    name = "stacking"
    extra_xml = """
    <body name="base_block" pos="-0.15 0.1 0.025">
      <geom name="base_geom" type="box" size="0.03 0.03 0.025"
            rgba="0.2 0.8 0.3 1"/>
    </body>"""

    def is_success(self, env):
        obj = self.body_pos(env, "object")
        base = self.body_pos(env, "base_block")
        return (np.linalg.norm(obj[:2] - base[:2]) < 0.03
                and 0.03 < obj[2] - base[2] < 0.08)

    def reward(self, env):
        obj = self.body_pos(env, "object")
        tgt = self.body_pos(env, "base_block") + [0, 0, 0.05]
        return -np.linalg.norm(obj - tgt) \
            - 0.5 * np.linalg.norm(env.ee_pos() - obj)


class ShelfPlacingTask(_ObjectTask):
    name = "shelf_placing"
    extra_xml = """
    <body name="shelf" pos="-0.25 0.0 0.0">
      <geom type="box" size="0.002 0.12 0.12" pos="-0.06 0 0.12" rgba="0.45 0.3 0.15 1"/>
      <geom name="shelf_board" type="box" size="0.06 0.12 0.002" pos="0 0 0.15"
            rgba="0.45 0.3 0.15 1"/>
    </body>"""

    def is_success(self, env):
        obj = self.body_pos(env, "object")
        gid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_GEOM,
                                "shelf_board")
        board = env.data.geom_xpos[gid]
        return (abs(obj[0] - board[0]) < 0.06 and abs(obj[1] - board[1]) < 0.12
                and 0.0 < obj[2] - board[2] < 0.06)

    def reward(self, env):
        gid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_GEOM,
                                "shelf_board")
        tgt = env.data.geom_xpos[gid] + [0, 0, 0.03]
        obj = self.body_pos(env, "object")
        return -np.linalg.norm(obj - tgt) \
            - 0.5 * np.linalg.norm(env.ee_pos() - obj)


class LeverPullTask(Task):
    name = "lever_pull"
    target_angle = 0.6
    extra_xml = """
    <body name="lever_base" pos="-0.2 0.2 0.02">
      <geom type="cylinder" size="0.02 0.02" rgba="0.3 0.3 0.3 1"/>
      <body name="lever" pos="0 0 0.03">
        <joint name="lever_hinge" type="hinge" axis="0 1 0" range="0 1.2"
               damping="1.5"/>
        <geom name="lever_arm" type="capsule" size="0.01"
              fromto="0 0 0 0.1 0 0" rgba="0.9 0.2 0.2 1"/>
        <geom name="lever_knob" type="sphere" size="0.018" pos="0.1 0 0"
              rgba="0.9 0.8 0.1 1"/>
      </body>
    </body>"""

    def _angle(self, env):
        jid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_JOINT,
                                "lever_hinge")
        return float(env.data.qpos[env.model.jnt_qposadr[jid]])

    def reward(self, env):
        gid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_GEOM,
                                "lever_knob")
        knob = env.data.geom_xpos[gid]
        return self._angle(env) - 0.2 * np.linalg.norm(env.ee_pos() - knob)

    def is_success(self, env):
        return self._angle(env) > self.target_angle


class ReachWallTask(ReachTask):
    name = "reach_wall"
    extra_xml = ReachTask.objects_xml + """
    <body name="wall" pos="0.0 0.0 0.08">
      <geom type="box" size="0.15 0.005 0.08" rgba="0.6 0.6 0.65 1"/>
    </body>"""
    objects_xml = ""

    def reset(self, model, data, rng):
        mid = model.body_mocapid[
            mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_BODY, "target")]
        data.mocap_pos[mid] = rng.uniform([-0.15, 0.08, 0.05],
                                          [0.15, 0.25, 0.2])


class PegInsertTask(Task):
    """Pick the peg up and insert it into the hole of a block.

    Reference: env/robot/peg_insert.py — staged reach/pick/place reward
    (:37-120) with a pickCompleted latch (:72-76), success = pegHead within
    a distance threshold of the goal site inside the hole (:182-185), peg
    and hole positions jittered per episode (:187-231). Distinct from
    peg_in_box: the target is a tight vertical hole (0.03 m square opening
    for a 0.024 m peg) the peg must enter, not an open box to drop into.
    """

    name = "peg_insert"
    threshold = 0.035
    objects_xml = """
    <body name="peg" pos="0.08 -0.05 0.055">
      <freejoint name="peg_joint"/>
      <geom name="peg_shaft" type="cylinder" size="0.012 0.05" mass="0.08"
            friction="1.5 0.01 0.0002" rgba="0.9 0.6 0.1 1"/>
      <site name="peg_head" pos="0 0 -0.05" size="0.004" rgba="1 0 0 1"/>
    </body>"""
    extra_xml = """
    <body name="hole_block" pos="-0.2 -0.15 0.05">
      <geom type="box" size="0.018 0.05 0.05" pos="-0.033 0 0"
            rgba="0.35 0.35 0.4 1"/>
      <geom type="box" size="0.018 0.05 0.05" pos="0.033 0 0"
            rgba="0.35 0.35 0.4 1"/>
      <geom type="box" size="0.015 0.0175 0.05" pos="0 -0.0325 0"
            rgba="0.35 0.35 0.4 1"/>
      <geom type="box" size="0.015 0.0175 0.05" pos="0 0.0325 0"
            rgba="0.35 0.35 0.4 1"/>
      <site name="hole_goal" pos="0 0 -0.035" size="0.005" rgba="0 1 0 0.5"/>
    </body>"""
    # the shared gripper's position servos (kp=120) pinch a 24 mm shaft at
    # ~0.7 N/finger; at the global friction that holds <1.5 N and the 0.8 N
    # peg slides through the grip during any lift (round-5 trace: ~6 mm/step
    # slip until the peg falls out of the finger span). Real grippers pad
    # their jaws — model that with a task-LOCAL high-friction contact pair
    # so every other task keeps the stock physics. (Reference peg_insert
    # relies on the vendored xArm gripper's much stiffer actuators,
    # env/robot/peg_insert.py.)
    root_xml = """
  <contact>
    <pair geom1="lfinger" geom2="peg_shaft" friction="6 6 0.05 0.01 0.01"
          solref="0.002 1" solimp="0.99 0.999 0.0001"/>
    <pair geom1="rfinger" geom2="peg_shaft" friction="6 6 0.05 0.01 0.01"
          solref="0.002 1" solimp="0.99 0.999 0.0001"/>
  </contact>"""

    def __init__(self):
        self._picked = False

    @staticmethod
    def _site(env, name):
        sid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_SITE, name)
        return env.data.site_xpos[sid].copy()

    def reset(self, model, data, rng):
        self._picked = False
        self._expert_hold = False  # scripted-expert hold latch (demos.py)
        jadr = model.jnt_qposadr[mujoco.mj_name2id(
            model, mujoco.mjtObj.mjOBJ_JOINT, "peg_joint")]
        data.qpos[jadr:jadr + 3] = [*(np.array([0.08, -0.05])
                                      + rng.uniform(-0.04, 0.04, 2)), 0.055]
        data.qpos[jadr + 3:jadr + 7] = [1, 0, 0, 0]
        bid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_BODY, "hole_block")
        model.body_pos[bid][:2] = (np.array([-0.2, -0.15])
                                   + rng.uniform(-0.03, 0.03, 2))

    def reward(self, env):
        peg = self.body_pos(env, "peg")
        head = self._site(env, "peg_head")
        goal = self._site(env, "hole_goal")
        reach = -float(np.linalg.norm(env.ee_pos() - peg))
        # pick latch: lifted clear of the block top and held near the hand
        lift_h = self.body_pos(env, "hole_block")[2] + 0.05 + 0.04
        if peg[2] > lift_h and -reach < 0.08:
            self._picked = True
        if peg[2] < 0.05 and -reach > 0.1:
            self._picked = False          # dropped
        place = -float(np.linalg.norm(head - goal))
        r = reach + (2.0 if self._picked else 0.0)
        if self._picked or place > -0.1:
            r += 3.0 * place
        return r

    def is_success(self, env):
        return float(np.linalg.norm(self._site(env, "peg_head")
                                    - self._site(env, "hole_goal"))) \
            < self.threshold

    def extra_obs(self, env):
        return np.concatenate([self._site(env, "peg_head"),
                               self._site(env, "hole_goal"),
                               [1.0 if self._picked else 0.0]])


class HammerTask(Task):
    """Drive the nail into its board by pressing it down.

    Reference: env/robot/hammer.py — reward approaches the nail then
    closes the nail->goal vertical gap (:26-45), the achieved goal is the
    nail site (:84-85), the nail board is jittered per episode (:87-99).
    Distinct bodies: a board with a spring-loaded nail on a vertical slide
    joint (friction holds it until pressed); success = nail driven to goal
    depth. Our gripper body itself is the striking tool (the reference
    welds a hammer into the xArm hand).
    """

    name = "hammer"
    drive_depth = 0.03      # slide travel (m) for success

    extra_xml = """
    <body name="nail_board" pos="-0.18 0.18 0.025">
      <geom name="board" type="box" size="0.06 0.06 0.025"
            rgba="0.5 0.35 0.2 1"/>
      <body name="nail" pos="0 0 0.025">
        <joint name="nail_slide" type="slide" axis="0 0 -1" range="0 0.035"
               damping="6" frictionloss="0.8"/>
        <geom name="nail_shaft" type="cylinder" size="0.005 0.05"
              pos="0 0 0.05" rgba="0.75 0.75 0.8 1" mass="0.02"
              contype="0" conaffinity="0"/>
        <geom name="nail_head" type="cylinder" size="0.016 0.005"
              pos="0 0 0.105" rgba="0.85 0.2 0.2 1" mass="0.02"/>
      </body>
    </body>"""

    def reset(self, model, data, rng):
        bid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_BODY, "nail_board")
        model.body_pos[bid][:2] = (np.array([-0.18, 0.18])
                                   + rng.uniform([-0.05, -0.1], [0.05, 0.1]))
        jadr = model.jnt_qposadr[mujoco.mj_name2id(
            model, mujoco.mjtObj.mjOBJ_JOINT, "nail_slide")]
        data.qpos[jadr] = 0.0

    def _drive(self, env) -> float:
        jid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_JOINT,
                                "nail_slide")
        return float(env.data.qpos[env.model.jnt_qposadr[jid]])

    def _nail_head(self, env):
        gid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_GEOM,
                                "nail_head")
        return env.data.geom_xpos[gid].copy()

    def reward(self, env):
        d_eef = float(np.linalg.norm(env.ee_pos() - self._nail_head(env)))
        remaining = max(0.0, self.drive_depth - self._drive(env))
        return -2.0 * d_eef - 2.0 * remaining

    def is_success(self, env):
        return self._drive(env) >= self.drive_depth

    def extra_obs(self, env):
        return self._nail_head(env)


class GolfTask(Task):
    """Putt the ball across the table into the hole.

    Reference: env/robot/golf.py — a rolling ball to a fixed far goal with
    a tight 0.035 m threshold and a success bonus in the dense reward
    (:23-31), ball spawned near the table center with xy jitter (:50-54),
    goal jittered along y only (:65-68). Ball physics match the reference
    asset (golf.xml:40: sphere, mass 2.0, near-zero friction 5e-5 — we keep
    a small 0.05 sliding mu for solver stability): a HEAVY low-friction
    sphere. The skill is guided gliding — the ball accelerates slowly under
    finger contact and coasts without stopping (condim 3, no rolling
    decay), so the expert must steer it continuously rather than strike it
    (a 30 g ball, by contrast, is flung along the axis-aligned finger-face
    normal at the first touch — round-5 forensics; the reference's mass-2
    ball is what makes golf controllable at all).
    """

    name = "golf"
    threshold = 0.035

    objects_xml = """
    <body name="ball" pos="0.05 -0.1 0.02">
      <freejoint name="ball_joint"/>
      <geom name="ball_geom" type="sphere" size="0.02" mass="2.0"
            friction="0.05 0.004 0.0001" rgba="0.95 0.95 0.95 1"/>
    </body>"""
    extra_xml = """
    <site name="hole" pos="-0.22 0.22 0.001" size="0.035 0.001"
          type="cylinder" rgba="0.05 0.3 0.05 1"/>"""

    def reset(self, model, data, rng):
        jadr = model.jnt_qposadr[mujoco.mj_name2id(
            model, mujoco.mjtObj.mjOBJ_JOINT, "ball_joint")]
        data.qpos[jadr:jadr + 3] = [*(np.array([0.05, -0.1])
                                      + rng.uniform(-0.04, 0.04, 2)), 0.02]
        data.qpos[jadr + 3:jadr + 7] = [1, 0, 0, 0]
        data.qvel[:] = 0.0
        sid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_SITE, "hole")
        model.site_pos[sid][1] = 0.22 + rng.uniform(-0.05, 0.025)

    def _hole(self, env):
        sid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_SITE, "hole")
        return env.data.site_xpos[sid].copy()

    def _dist(self, env) -> float:
        return float(np.linalg.norm(
            self.body_pos(env, "ball")[:2] - self._hole(env)[:2]))

    def _ball_speed(self, env) -> float:
        jid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_JOINT,
                                "ball_joint")
        vadr = env.model.jnt_dofadr[jid]
        return float(np.linalg.norm(env.data.qvel[vadr:vadr + 2]))

    def reward(self, env):
        d = self._dist(env)
        ball = self.body_pos(env, "ball")
        shape = 0.0 if self._ball_speed(env) > 0.02 else \
            -0.3 * float(np.linalg.norm(env.ee_pos() - ball))
        bonus = round(1.0 - d, 4) if d <= self.threshold else 0.0
        return round(-d, 4) + shape + bonus

    def is_success(self, env):
        return self._dist(env) < self.threshold

    def extra_obs(self, env):
        # hole pose + planar ball velocity. The velocity term makes the
        # expert's "wait while the ball rolls" policy observable: without
        # it a BC clone sees identical states for a rolling and a resting
        # ball and averages the strike with the retreat (round-4 golf BC
        # collapsed to 2% for exactly this reason). The reference's
        # _get_state_obs embeds object velocities too (env/robot/
        # gym_wrapper.py obs concat includes qvel-derived object state).
        jid = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_JOINT,
                                "ball_joint")
        vadr = env.model.jnt_dofadr[jid]
        return np.concatenate(
            [self._hole(env), env.data.qvel[vadr:vadr + 2]])


TASK_REGISTRY: Dict[str, Type[Task]] = {
    t.name: t for t in [
        ReachTask, PushTask, LiftTask, PickPlaceTask, PegInBoxTask,
        DrawerTask, DrawerCloseTask, StackingTask, ShelfPlacingTask,
        LeverPullTask, ReachWallTask, PegInsertTask, HammerTask, GolfTask]
}


# ----------------------------------------------------------------------- env
_SCENE_TEMPLATE = """
<mujoco model="xarm_{task}">
  <option timestep="0.002" integrator="implicitfast"/>
  <visual><headlight diffuse="0.8 0.8 0.8"/></visual>
  <worldbody>
    <light pos="0 0 2" dir="0 0 -1"/>
    <geom name="table" type="plane" size="0.6 0.6 0.05" rgba="0.85 0.82 0.78 1"
          friction="1.5 0.01 0.0002"/>
    <body name="gripper" pos="0 0 0.25" mocap="true">
      <geom name="palm" type="box" size="0.035 0.012 0.012" rgba="0.2 0.2 0.22 1"
            contype="0" conaffinity="0"/>
    </body>
    <body name="hand" pos="0 0 0.25">
      <freejoint name="hand_joint"/>
      <geom name="hand_core" type="sphere" size="0.012" mass="0.4"
            rgba="0.25 0.25 0.3 1"/>
      <body name="left_finger" pos="-0.048 0 -0.035">
        <joint name="lfinger_joint" type="slide" axis="1 0 0" range="0 0.036"
               damping="20"/>
        <geom name="lfinger" type="box" size="0.006 0.014 0.035"
              rgba="0.3 0.3 0.35 1" friction="2 0.05 0.001" mass="0.05"/>
      </body>
      <body name="right_finger" pos="0.048 0 -0.035">
        <joint name="rfinger_joint" type="slide" axis="-1 0 0" range="0 0.036"
               damping="20"/>
        <geom name="rfinger" type="box" size="0.006 0.014 0.035"
              rgba="0.3 0.3 0.35 1" friction="2 0.05 0.001" mass="0.05"/>
      </body>
    </body>
    {objects}
    {extra}
    <camera name="front" pos="0.9 0 0.5" xyaxes="0 1 0 -0.45 0 0.9" fovy="45"/>
    <camera name="side" pos="0 0.9 0.5" xyaxes="-1 0 0 0 -0.45 0.9" fovy="45"/>
    <camera name="top" pos="0 0 1.1" xyaxes="1 0 0 0 1 0" fovy="45"/>
    <camera name="dynamic" pos="0.8 0.3 0.6" xyaxes="0 1 0 -0.5 0 0.85" fovy="45"/>
  </worldbody>
  <equality>
    <weld body1="gripper" body2="hand" solref="0.004 1"/>
  </equality>
  <actuator>
    <position joint="lfinger_joint" kp="120" ctrlrange="0 0.036"/>
    <position joint="rfinger_joint" kp="120" ctrlrange="0 0.036"/>
  </actuator>
  {root}
</mujoco>
"""


class XArmSimEnv(gym.Env):
    """Cartesian mocap-controlled manipulation env.

    action: (dx, dy, dz, grip) in [-1, 1]; grip > 0 closes the fingers.
    observation modes: 'state' (ee pos + finger + task object state),
    'image' (H, W, 3), 'depth', 'pointcloud' {points, colors}.
    """

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, task_name: str = "reach", obs_mode: str = "state",
                 image_size: int = 64, action_scale: float = 0.04,
                 n_substeps: int = 20, seed: int = 0,
                 cameras=("front",)):
        self.task: Task = TASK_REGISTRY[task_name]()
        xml = _SCENE_TEMPLATE.format(task=task_name,
                                     objects=self.task.objects_xml,
                                     extra=self.task.extra_xml,
                                     root=self.task.root_xml)
        self.model = mujoco.MjModel.from_xml_string(xml)
        self.data = mujoco.MjData(self.model)
        self.obs_mode = obs_mode
        self.image_size = image_size
        self.action_scale = action_scale
        self.n_substeps = n_substeps
        self.cameras = list(cameras)
        self.renderer = RaycastRenderer(self.model, image_size, image_size)
        self._rng = np.random.default_rng(seed)
        self._mocap_id = self.model.body_mocapid[
            mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_BODY, "gripper")]

        self.action_space = gym.spaces.Box(-1.0, 1.0, (4,), np.float32)
        self.observation_space = self._make_obs_space()

    # ------------------------------------------------------------- helpers
    def _make_obs_space(self):
        if self.obs_mode == "state":
            dim = self._state_obs().shape[0]
            return gym.spaces.Box(-np.inf, np.inf, (dim,), np.float32)
        if self.obs_mode == "image":
            return gym.spaces.Box(0.0, 1.0,
                                  (self.image_size, self.image_size, 3),
                                  np.float32)
        if self.obs_mode == "depth":
            return gym.spaces.Box(0.0, np.inf,
                                  (self.image_size, self.image_size),
                                  np.float32)
        if self.obs_mode == "pointcloud":
            return gym.spaces.Dict({
                "points": gym.spaces.Box(-np.inf, np.inf, (0, 3), np.float32),
                "colors": gym.spaces.Box(0, 1, (0, 3), np.float32)})
        raise ValueError(self.obs_mode)

    def ee_pos(self) -> np.ndarray:
        bid = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_BODY, "hand")
        return self.data.xpos[bid].copy()

    def gripper_open(self) -> float:
        jid = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_JOINT,
                                "lfinger_joint")
        q = float(self.data.qpos[self.model.jnt_qposadr[jid]])
        return float(np.clip(1.0 - q / 0.036, 0.0, 1.0))

    def _state_obs(self) -> np.ndarray:
        parts = [self.ee_pos(), [self.gripper_open()]]
        # free-joint object states (skip the hand's own freejoint)
        for j in range(self.model.njnt):
            if self.model.jnt_type[j] == mujoco.mjtJoint.mjJNT_FREE:
                name = mujoco.mj_id2name(self.model, mujoco.mjtObj.mjOBJ_JOINT, j)
                if name == "hand_joint":
                    continue
                adr = self.model.jnt_qposadr[j]
                parts.append(self.data.qpos[adr:adr + 3])
            elif self.model.jnt_type[j] in (mujoco.mjtJoint.mjJNT_SLIDE,
                                            mujoco.mjtJoint.mjJNT_HINGE):
                name = mujoco.mj_id2name(self.model, mujoco.mjtObj.mjOBJ_JOINT, j)
                if name in ("lfinger_joint", "rfinger_joint"):
                    continue
                parts.append([self.data.qpos[self.model.jnt_qposadr[j]]])
        for i in range(self.model.nmocap):
            if i != self._mocap_id:
                parts.append(self.data.mocap_pos[i])
        extra = self.task.extra_obs(self)
        if extra is not None:
            parts.append(extra)
        return np.concatenate([np.atleast_1d(np.asarray(p, np.float32))
                               for p in parts])

    def _obs(self):
        if self.obs_mode == "state":
            return self._state_obs()
        if self.obs_mode == "image":
            return self.renderer.render(self.data, self.cameras[0]).rgb
        if self.obs_mode == "depth":
            return self.renderer.render(self.data, self.cameras[0]).depth
        if self.obs_mode == "pointcloud":
            gen = PointCloudGenerator(self.model, self.cameras,
                                      self.image_size, self.image_size)
            pts, cols = gen.generate(self.data)
            return {"points": pts, "colors": cols}
        raise ValueError(self.obs_mode)

    # ----------------------------------------------------------------- API
    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        mujoco.mj_resetData(self.model, self.data)
        start = self._rng.uniform([-0.1, -0.1, 0.15], [0.1, 0.1, 0.3])
        self.data.mocap_pos[self._mocap_id] = start
        # teleport the hand to the mocap target
        jadr = self.model.jnt_qposadr[mujoco.mj_name2id(
            self.model, mujoco.mjtObj.mjOBJ_JOINT, "hand_joint")]
        self.data.qpos[jadr:jadr + 3] = start
        self.task.reset(self.model, self.data, self._rng)
        mujoco.mj_forward(self.model, self.data)
        return self._obs(), {}

    def step(self, action):
        action = np.clip(np.asarray(action, np.float64), -1.0, 1.0)
        target = self.data.mocap_pos[self._mocap_id] + \
            action[:3] * self.action_scale
        self.data.mocap_pos[self._mocap_id] = np.clip(
            target, WORKSPACE[0], WORKSPACE[1])
        close = 0.036 if action[3] > 0 else 0.0
        self.data.ctrl[:2] = close
        for _ in range(self.n_substeps):
            mujoco.mj_step(self.model, self.data)
        reward = float(self.task.reward(self))
        success = bool(self.task.is_success(self))
        return self._obs(), reward, False, False, {"success": success}

    def render(self):
        return (self.renderer.render(self.data, self.cameras[0]).rgb
                * 255).astype(np.uint8)

    # camera info (CameraPosWrapper parity)
    def camera_extrinsic(self, cam: str) -> np.ndarray:
        return camera_pose(self.model, self.data, cam)

    def camera_intrinsic(self, cam: str) -> np.ndarray:
        cid = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_CAMERA, cam)
        return camera_intrinsics(float(self.model.cam_fovy[cid]),
                                 self.image_size, self.image_size)

    def set_camera_pose(self, cam: str, pos, xyaxes=None):
        cid = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_CAMERA, cam)
        self.model.cam_pos[cid] = pos
        if xyaxes is not None:
            x = np.asarray(xyaxes[:3], np.float64)
            y = np.asarray(xyaxes[3:], np.float64)
            z = np.cross(x, y)
            mat = np.stack([x / np.linalg.norm(x), y / np.linalg.norm(y),
                            z / np.linalg.norm(z)], axis=1)
            quat = np.empty(4)
            mujoco.mju_mat2Quat(quat, mat.reshape(-1))
            self.model.cam_quat[cid] = quat
        mujoco.mj_forward(self.model, self.data)
