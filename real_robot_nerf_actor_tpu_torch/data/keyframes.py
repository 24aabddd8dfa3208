"""Keyframe demonstrations: the pose arrays of one demo, the xArm pose-dump
parser and keyframe discovery in a dense trajectory (the port's copy of the
JAX package's `data/keyframes.py`)."""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class KeyframeDemo:
    """One demonstration: per-keyframe pose arrays.

    xyz: (K, 3) metres; rotation: (K, 3) degrees (roll, pitch, yaw);
    gripper_open: (K,) float 0/1.
    """

    xyz: np.ndarray
    rotation: np.ndarray
    gripper_open: np.ndarray

    @property
    def num_keyframes(self) -> int:
        return self.xyz.shape[0]


def parse_xarm_position_file(path: str) -> KeyframeDemo:
    """Parse an xArm keyframe pose dump.

    Each line is a bracketed CSV [x, y, z, roll, pitch, yaw, ..., gripper]
    with positions in mm and a True/False (or numeric) gripper flag.
    """
    values: List[List[float]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            line = line.replace("[", "").replace("]", "")
            row: List[float] = []
            for tok in line.split(","):
                tok = tok.strip()
                if not tok:
                    continue
                try:
                    row.append(float(tok))
                except ValueError:
                    row.append(1.0 if "True" in tok else 0.0)
            if row:
                values.append(row)
    arr = np.asarray(values, dtype=np.float64)
    return KeyframeDemo(
        xyz=(arr[:, 0:3] * 0.001).astype(np.float32),
        rotation=arr[:, 3:6].astype(np.float32),
        gripper_open=arr[:, -1].astype(np.float32),
    )


def extract_keyframes(gripper_open: Sequence[float], roll: Sequence[float],
                      roll_tol: float = 1.0) -> List[int]:
    """Keyframe indices of a dense trajectory: a frame where the gripper
    state changes, the first frame whose roll is within roll_tol degrees of
    the final roll, and the final frame."""
    g = np.asarray(gripper_open)
    r = np.asarray(roll)
    n = len(g)
    keys: List[int] = []
    final_roll = r[-1]
    roll_reached = False
    for i in range(1, n):
        if g[i] != g[i - 1]:
            keys.append(i)
        if not roll_reached and abs(r[i] - final_roll) < roll_tol:
            roll_reached = True
            if i not in keys:
                keys.append(i)
    if n - 1 not in keys:
        keys.append(n - 1)
    return sorted(set(keys))
