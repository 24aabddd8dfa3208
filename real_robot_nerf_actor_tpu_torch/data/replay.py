"""Robot/camera I/O behind a protocol, with a replay implementation
(counterpart of the JAX package's `data/replay.py`, the parts the act loop
uses). `RobotIO` is what a hardware backend implements; `ReplayRobotIO`
serves recorded steps so the deployment loop runs without a robot.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Tuple

import numpy as np


@dataclasses.dataclass
class PointCloudSample:
    """One observation: points in the robot-base frame + colors in [-1, 1].

    `valid` marks real rows of a pre-padded cloud (False = padding); None
    means every row is a real point."""

    points: np.ndarray                  # (N, 3) float32, metres
    colors: np.ndarray                  # (N, 3) float32 in [-1, 1]
    valid: Optional[np.ndarray] = None  # (N,) bool


def pad_point_cloud(sample: PointCloudSample, max_num_coords: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad with zeros or truncate to `max_num_coords` rows; returns
    (points, colors, valid mask)."""
    n = sample.points.shape[0]
    if n >= max_num_coords:
        valid = (np.asarray(sample.valid[:max_num_coords], bool)
                 if sample.valid is not None else np.ones(max_num_coords, bool))
        return (sample.points[:max_num_coords],
                sample.colors[:max_num_coords], valid)
    pad = max_num_coords - n
    pts = np.concatenate([sample.points, np.zeros((pad, 3), np.float32)])
    cols = np.concatenate([sample.colors, np.zeros((pad, 3), np.float32)])
    base_valid = (np.asarray(sample.valid, bool) if sample.valid is not None
                  else np.ones(n, bool))
    valid = np.concatenate([base_valid, np.zeros(pad, bool)])
    return pts, cols, valid


class RobotIO(Protocol):
    """Hardware abstraction used by the deployment loop (train/serve.py)."""

    def capture_pointcloud(self) -> PointCloudSample: ...

    def get_proprio(self) -> Tuple[np.ndarray, np.ndarray, float]:
        """Returns (xyz metres, rotation degrees, gripper_open)."""
        ...

    def move_to(self, xyz: np.ndarray, rotation_deg: np.ndarray,
                gripper_open: float) -> None: ...


@dataclasses.dataclass
class ReplayStep:
    observation: PointCloudSample
    proprio_xyz: np.ndarray
    proprio_rot: np.ndarray
    proprio_grip: float


class ReplayRobotIO:
    """RobotIO that replays recorded steps; `move_to` records the commanded
    actions and advances to the next step."""

    def __init__(self, steps: List[ReplayStep]):
        self._steps = steps
        self._t = 0
        self.commands: List[Tuple[np.ndarray, np.ndarray, float]] = []

    def capture_pointcloud(self) -> PointCloudSample:
        return self._steps[min(self._t, len(self._steps) - 1)].observation

    def get_proprio(self):
        s = self._steps[min(self._t, len(self._steps) - 1)]
        return s.proprio_xyz, s.proprio_rot, s.proprio_grip

    def move_to(self, xyz, rotation_deg, gripper_open):
        self.commands.append((np.asarray(xyz), np.asarray(rotation_deg),
                              float(gripper_open)))
        self._t += 1
