"""Trajectories, keyframe discovery and keyframe interpolation (the numpy
half of the JAX package's `data/demos.py`).

  - Trajectory: one recorded episode (observations, actions, rewards,
    gripper openness, end-effector positions, success);
  - KeyframeBuffer: a frame is a keyframe where the gripper flips, or where
    the end effector stops (moved less than `stop_threshold` since the
    previous frame, the last frame excepted), plus the last frame;
  - simple_motion_planning: linear end-effector interpolation between
    keyframes.

Not ported (they need the MuJoCo envs, which the port does not have yet):
`scripted_expert`, `generate_demonstrations` and `generate_nerf_scene`.
This module imports no env.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Trajectory:
    observations: List
    actions: List[np.ndarray]
    rewards: List[float]
    gripper_open: List[float]
    ee_positions: List[np.ndarray]
    success: bool


class KeyframeBuffer:
    """Keyframe discovery and storage over trajectories."""

    def __init__(self, stop_threshold: float = 2e-3):
        self.stop_threshold = stop_threshold
        self.keyframes: List[Dict] = []

    def _discover(self, tr: Trajectory) -> List[int]:
        n = len(tr.actions)
        ks: List[int] = []
        for i in range(1, n):
            if (tr.gripper_open[i] > 0.5) != (tr.gripper_open[i - 1] > 0.5):
                ks.append(i)
            elif (i + 1 < n and np.linalg.norm(tr.ee_positions[i] - tr.ee_positions[i - 1])
                  < self.stop_threshold):
                ks.append(i)
        ks.append(n - 1)
        return sorted(set(ks))

    def add_trajectory(self, tr: Trajectory):
        for k in self._discover(tr):
            self.keyframes.append({"obs": tr.observations[k], "ee_pos": tr.ee_positions[k],
                                   "gripper_open": tr.gripper_open[k],
                                   "action": tr.actions[k]})

    def __len__(self):
        return len(self.keyframes)

    def sample(self, batch_size: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        idx = rng.integers(0, len(self.keyframes), batch_size)
        return [self.keyframes[i] for i in idx]


def simple_motion_planning(start: np.ndarray, goal: np.ndarray,
                           n_steps: int = 10) -> np.ndarray:
    """n_steps points from start (excluded) to goal (included), evenly
    spaced on the segment: (n_steps, 3)."""
    ts = np.linspace(0.0, 1.0, n_steps + 1)[1:, None]
    return start[None] * (1 - ts) + goal[None] * ts
