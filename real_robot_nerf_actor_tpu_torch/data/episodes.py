"""Stored episodes -> keyframe PerAct batches (counterpart of the JAX
package's `data/episodes.py`).

Episodes are npz files, key for key the JAX package's (actions, rewards,
ee_positions, gripper_open, success, and observations or obs_points /
obs_colors for point clouds cut to the episode's smallest cloud), or
in-memory `Trajectory`s. `EpisodeDataset` pairs each keyframe (discovered
with KeyframeBuffer's rules) with the next one, in the field layout of
PerActTrainer.train_step; `get` is numpy, `batches` yields tensors on the
device it is given.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from real_robot_nerf_actor_tpu_torch.data.demos import KeyframeBuffer, Trajectory
from real_robot_nerf_actor_tpu_torch.data.replay import PointCloudSample, pad_point_cloud


def save_trajectory(path: str, tr: Trajectory, pointclouds=None) -> None:
    """Write `tr` as an .npz. `pointclouds` is accepted and ignored, as the
    JAX package's signature takes and ignores it: point-cloud observations
    travel in `tr.observations`."""
    data = dict(actions=np.stack(tr.actions), rewards=np.asarray(tr.rewards),
                ee_positions=np.stack(tr.ee_positions),
                gripper_open=np.asarray(tr.gripper_open), success=tr.success)
    if isinstance(tr.observations[0], dict):      # point-cloud observations
        n = min(o["points"].shape[0] for o in tr.observations)
        data["obs_points"] = np.stack([o["points"][:n] for o in tr.observations])
        data["obs_colors"] = np.stack([o["colors"][:n] for o in tr.observations])
    else:
        data["observations"] = np.stack(tr.observations)
    np.savez_compressed(path, **data)


def load_trajectory(path: str) -> Trajectory:
    z = np.load(path)
    if "obs_points" in z:
        obs = [{"points": p, "colors": c} for p, c in zip(z["obs_points"], z["obs_colors"])]
    else:
        obs = list(z["observations"])
    return Trajectory(observations=obs, actions=list(z["actions"]), rewards=list(z["rewards"]),
                      gripper_open=list(z["gripper_open"]),
                      ee_positions=list(z["ee_positions"]), success=bool(z["success"]))


class EpisodeDataset:
    """Keyframe pairs over stored episodes (a directory of npz files or a
    list of Trajectory): sample i is (a keyframe's point cloud and proprio,
    the next keyframe's action). Sim episodes store no wrist rotation: both
    keyframes' rotation is identity."""

    def __init__(self, root_or_trajs, coord_bounds, voxel_size: int = 100,
                 rotation_resolution: float = 5.0, max_num_coords: int = 220000,
                 lang_embs: Optional[np.ndarray] = None, lang_shape=(77, 512)):
        if isinstance(root_or_trajs, str):
            paths = sorted(glob.glob(os.path.join(root_or_trajs, "*.npz")))
            self.trajs = [load_trajectory(p) for p in paths]
        else:
            self.trajs = list(root_or_trajs)
        if not self.trajs:
            raise ValueError("no trajectories")
        self.bounds = np.asarray(coord_bounds, np.float32)
        self.voxel_size = voxel_size
        self.rotation_resolution = rotation_resolution
        self.max_num_coords = max_num_coords
        self.lang = lang_embs if lang_embs is not None else np.zeros(lang_shape, np.float32)
        buf = KeyframeBuffer()
        self._kf: List[List[int]] = [buf._discover(t) for t in self.trajs]
        self.samples = [(ti, pi) for ti, ks in enumerate(self._kf) for pi in range(len(ks) - 1)]
        if not self.samples:
            raise ValueError("no keyframe pairs discovered")

    def __len__(self):
        return len(self.samples)

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        ti, pi = self.samples[idx]
        tr = self.trajs[ti]
        cur, nxt = self._kf[ti][pi], self._kf[ti][pi + 1]
        obs = tr.observations[cur]
        if not isinstance(obs, dict):
            raise ValueError("episode observations must be point clouds for PerAct "
                             "batches (obs_mode='pointcloud')")
        pts, cols, valid = pad_point_cloud(
            PointCloudSample(np.asarray(obs["points"], np.float32),
                             np.asarray(obs["colors"], np.float32) * 2.0 - 1.0),
            self.max_num_coords)
        # identity rotation: the bin of 0 degrees on each axis
        rot_bins = np.full(3, int(180.0 / self.rotation_resolution) - 1, np.int32)
        grip = int(tr.gripper_open[nxt] > 0.5)
        return {
            "points": pts, "colors": cols, "valid": valid,
            "proprio": np.concatenate([np.zeros(3), rot_bins,
                                       [float(tr.gripper_open[cur] > 0.5)]]).astype(np.float32),
            "lang": self.lang,
            "kf_xyz": np.stack([tr.ee_positions[cur], tr.ee_positions[nxt]]).astype(np.float32),
            "rot_grip": np.concatenate([rot_bins, [grip]]).astype(np.int32),
            "collision": np.asarray([1], np.int32),
        }

    def batches(self, batch_size: int = 1, seed: int = 0, device="cuda"
                ) -> Iterator[Dict[str, torch.Tensor]]:
        """Endless batches of samples drawn uniformly with numpy's
        default_rng(seed) (the JAX package's draws), stacked and put on
        `device`."""
        from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        while True:
            items = [self.get(int(i)) for i in rng.integers(0, len(self.samples), batch_size)]
            yield {k: torch.as_tensor(np.stack([it[k] for it in items])).to(dev)
                   for k in items[0]}
