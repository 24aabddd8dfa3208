"""Robot/camera I/O behind a protocol, with replay implementations
(counterpart of the JAX package's `data/replay.py`). `RobotIO` is what a
hardware backend implements; `ReplayRobotIO` serves recorded steps so the
deployment loop runs without a robot; `ReplaySource` reads a recording of
keyframe demos in the on-disk layout the trainers consume. Views are read
by the port's own PNG codec (`data/png.py`), not PIL.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Protocol, Tuple

import numpy as np

from real_robot_nerf_actor_tpu_torch.data.keyframes import (
    KeyframeDemo, parse_xarm_position_file)
from real_robot_nerf_actor_tpu_torch.data.ply import read_ply
from real_robot_nerf_actor_tpu_torch.data.png import read_png_rgb


@dataclasses.dataclass
class PointCloudSample:
    """One observation: points in the robot-base frame + colors in [-1, 1].

    `valid` marks real rows of a pre-padded cloud (False = padding); None
    means every row is a real point."""

    points: np.ndarray                  # (N, 3) float32, metres
    colors: np.ndarray                  # (N, 3) float32 in [-1, 1]
    valid: Optional[np.ndarray] = None  # (N,) bool


def load_rgb_pcd(pcd_path: str, cam2base: np.ndarray,
                 max_range: float = 3.0) -> PointCloudSample:
    """Load a .ply in the camera frame: drop points with ||p|| >= max_range,
    move the rest to the base frame (p @ R^T + t) and map rgb to [-1, 1]."""
    pts, colors = read_ply(pcd_path)
    if colors is None:
        colors = np.zeros_like(pts)
    keep = np.linalg.norm(pts, axis=1) < max_range
    pts, colors = pts[keep], colors[keep]
    pts = pts @ cam2base[:3, :3].T + cam2base[:3, 3]
    colors = (colors - 0.5) / 0.5
    return PointCloudSample(points=pts.astype(np.float32),
                            colors=colors.astype(np.float32))


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


class ReplaySource:
    """Keyframe-demo dataset over a directory tree:

        root/
          calibration.json               # cam2base / gt_pose / focal (optional)
          {demo}_xarm_position.txt       # keyframe poses
          real{demo}/pcd{k}.ply          # per-keyframe point clouds
          real{demo}/rgb{k}.png          # ground-truth view (optional)
          real{demo}/embed{k}.npy        # teacher features (optional)
          real{demo}/depth{k}.npy        # ground-truth depth (optional)
          real{demo}/holdout{k}.png      # held-out view (optional)

    Extra training cameras v >= 1 add `_v{v}` before the suffix. cam2base:
    an explicit override; else calibration.json's, else the identity.
    """

    def __init__(self, root: str, n_demos: int, cam2base: Optional[np.ndarray] = None):
        self.root = root
        self.calibration: dict = {}
        calib_path = os.path.join(root, "calibration.json")
        if os.path.exists(calib_path):
            with open(calib_path) as f:
                self.calibration = json.load(f)
        if cam2base is None:
            cam2base = np.asarray(self.calibration.get("cam2base", np.eye(4)), np.float64)
        self.cam2base = cam2base
        self.demos: List[KeyframeDemo] = [
            parse_xarm_position_file(os.path.join(root, f"{d}_xarm_position.txt"))
            for d in range(n_demos)]

    def num_keyframes(self, demo: int) -> int:
        return self.demos[demo].num_keyframes

    def pose(self, demo: int, k: int):
        d = self.demos[demo]
        return d.xyz[k], d.rotation[k], d.gripper_open[k]

    def pointcloud(self, demo: int, k: int) -> PointCloudSample:
        return load_rgb_pcd(os.path.join(self.root, f"real{demo}", f"pcd{k}.ply"),
                            self.cam2base)

    # ------------------------------------------------------- ground-truth views
    @property
    def has_views(self) -> bool:
        """True when the recording carries ground-truth RGB views (the joint
        trainer needs them; PerAct-only recordings may omit them)."""
        return os.path.exists(os.path.join(self.root, "real0", "rgb0.png"))

    @property
    def gt_pose(self) -> np.ndarray:
        """(4, 4) OpenGL camera-to-world pose of the training view; cam2base
        where the calibration names none."""
        return np.asarray(self.calibration.get("gt_pose", self.cam2base), np.float32)

    @property
    def focal(self) -> float:
        return float(self.calibration.get("focal", 76.18))

    @property
    def has_holdout(self) -> bool:
        """True when the recording carries a second view that training never
        sees (real{d}/holdout{k}.png and the calibration's holdout_pose)."""
        return ("holdout_pose" in self.calibration and os.path.exists(
            os.path.join(self.root, "real0", "holdout0.png")))

    @property
    def holdout_pose(self) -> np.ndarray:
        return np.asarray(self.calibration["holdout_pose"], np.float32)

    def holdout_view(self, demo: int, k: int) -> dict:
        rgb = read_png_rgb(os.path.join(self.root, f"real{demo}", f"holdout{k}.png"))
        return {"rgb": rgb.astype(np.float32) / 255.0, "pose": self.holdout_pose,
                "focal": self.focal}

    @property
    def n_train_views(self) -> int:
        """Distinct training cameras (the calibration's train_poses; 1 without)."""
        return max(1, len(self.calibration.get("train_poses", [])))

    def train_pose(self, v: int = 0) -> np.ndarray:
        tp = self.calibration.get("train_poses")
        return np.asarray(tp[v], np.float32) if tp else self.gt_pose

    def view(self, demo: int, k: int, v: int = 0) -> dict:
        """Ground-truth view of keyframe k from camera v: 'rgb' (H,W,3) in
        [0,1], 'pose' (4,4), 'focal', and where recorded 'embed' (H,W,D) and
        'depth' (H,W), as float32."""
        ddir = os.path.join(self.root, f"real{demo}")
        sfx = "" if v == 0 else f"_v{v}"
        rgb = read_png_rgb(os.path.join(ddir, f"rgb{k}{sfx}.png"))
        out = {"rgb": rgb.astype(np.float32) / 255.0, "pose": self.train_pose(v),
               "focal": self.focal}
        epath = os.path.join(ddir, f"embed{k}{sfx}.npy")
        if os.path.exists(epath):
            out["embed"] = np.load(epath).astype(np.float32)
        dpath = os.path.join(ddir, f"depth{k}{sfx}.npy")
        if os.path.exists(dpath):
            out["depth"] = np.load(dpath).astype(np.float32)
        return out
