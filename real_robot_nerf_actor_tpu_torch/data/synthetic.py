"""Synthetic scene + keyframe demo (counterpart of the JAX package's
`data/synthetic.py`, the parts the act loop uses).

A table plane plus a few coloured boxes inside the scene bounds, and a
grasp-like keyframe trajectory above box 0: the same numpy draws as the JAX
package, so both packages see the same clouds for the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from real_robot_nerf_actor_tpu_torch.data.keyframes import KeyframeDemo
from real_robot_nerf_actor_tpu_torch.data.replay import PointCloudSample, ReplayStep


@dataclasses.dataclass
class SyntheticScene:
    points: np.ndarray      # (N, 3)
    colors: np.ndarray      # (N, 3) in [-1, 1]
    box_centers: np.ndarray  # (n_boxes, 3)
    # analytic description of the scene:
    box_halves: np.ndarray = None   # (n_boxes, 3)
    box_colors: np.ndarray = None   # (n_boxes, 3) in [0, 1]
    table_z: float = 0.0
    table_color: np.ndarray = None  # (3,) in [0, 1]
    bounds: np.ndarray = None       # (6,)


def make_synthetic_scene(seed: int = 0, n_points: int = 60000,
                         bounds=(-0.1, -0.3, -0.2, 0.8, 0.7, 0.7),
                         n_boxes: int = 3,
                         table_color=(0.1, 0.05, 0.0)) -> SyntheticScene:
    rng = np.random.default_rng(seed)
    bmin = np.asarray(bounds[:3], np.float32)
    bmax = np.asarray(bounds[3:], np.float32)
    span = bmax - bmin

    n_table = n_points // 2
    table = np.empty((n_table, 3), np.float32)
    table[:, 0] = rng.uniform(bmin[0], bmax[0], n_table)
    table[:, 1] = rng.uniform(bmin[1], bmax[1], n_table)
    table[:, 2] = bmin[2] + 0.02 + rng.normal(0, 0.002, n_table)
    table_c = np.tile(np.asarray([table_color], np.float32), (n_table, 1))
    table_c += rng.normal(0, 0.02, table_c.shape)

    box_pts: List[np.ndarray] = []
    box_cols: List[np.ndarray] = []
    centers = []
    halves = []
    palette = np.array([[0.9, 0.1, 0.1], [0.1, 0.8, 0.2], [0.2, 0.3, 0.9],
                        [0.9, 0.8, 0.1]], np.float32)
    n_per_box = (n_points - n_table) // n_boxes
    for i in range(n_boxes):
        c = bmin + span * rng.uniform(0.25, 0.75, 3)
        c[2] = bmin[2] + 0.08
        centers.append(c)
        half = rng.uniform(0.03, 0.06, 3)
        halves.append(half)
        face = rng.integers(0, 3, n_per_box)
        sign = rng.choice([-1.0, 1.0], n_per_box)
        p = rng.uniform(-1, 1, (n_per_box, 3)) * half
        p[np.arange(n_per_box), face] = sign * half[face]
        box_pts.append(c + p)
        col = np.tile(palette[i % len(palette)], (n_per_box, 1))
        box_cols.append(col + rng.normal(0, 0.02, col.shape))

    pts = np.concatenate([table] + box_pts).astype(np.float32)
    cols = np.concatenate([table_c] + box_cols).astype(np.float32)
    cols = np.clip(cols, 0, 1) * 2.0 - 1.0  # reference rgb normalization
    box_colors = np.stack([palette[i % len(palette)] for i in range(n_boxes)])
    return SyntheticScene(points=pts, colors=cols,
                          box_centers=np.asarray(centers, np.float32),
                          box_halves=np.asarray(halves, np.float32),
                          box_colors=box_colors.astype(np.float32),
                          table_z=float(bmin[2] + 0.02),
                          table_color=np.asarray(table_color, np.float32),
                          bounds=np.asarray(bounds, np.float32))


def make_synthetic_demo(scene: SyntheticScene, seed: int = 0,
                        n_keyframes: int = 5) -> KeyframeDemo:
    """A grasp-like keyframe trajectory: approach above box 0, descend,
    close gripper, lift."""
    rng = np.random.default_rng(seed)
    target = scene.box_centers[0]
    above = target + np.array([0, 0, 0.25], np.float32)
    lift = target + np.array([0, 0, 0.35], np.float32)
    waypoints = np.stack([
        above + rng.normal(0, 0.01, 3),
        target + np.array([0, 0, 0.10], np.float32),
        target + np.array([0, 0, 0.03], np.float32),
        target + np.array([0, 0, 0.03], np.float32),
        lift,
    ][: n_keyframes]).astype(np.float32)
    rot = np.tile(np.array([[180.0, 0.0, 0.0]], np.float32), (n_keyframes, 1))
    rot += rng.normal(0, 2.0, rot.shape).astype(np.float32)
    grip = np.array([1, 1, 1, 0, 0][:n_keyframes], np.float32)
    return KeyframeDemo(xyz=waypoints, rotation=rot, gripper_open=grip)


def make_replay_steps(scene: SyntheticScene, demo: KeyframeDemo
                      ) -> List[ReplayStep]:
    obs = PointCloudSample(points=scene.points, colors=scene.colors)
    return [
        ReplayStep(observation=obs, proprio_xyz=demo.xyz[k],
                   proprio_rot=demo.rotation[k],
                   proprio_grip=float(demo.gripper_open[k]))
        for k in range(demo.num_keyframes)
    ]
