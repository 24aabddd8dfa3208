"""Keyframe demonstrations (the port's copy of `KeyframeDemo` from the JAX
package's `data/keyframes.py`)."""
from __future__ import annotations

import dataclasses

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
