"""NeRF scene datasets (npz-backed) and synthetic scenes (the port's copy of
the JAX package's `data/scene_dataset.py`; the files are the same, so
either package reads what the other writes).

A scene npz holds images (N, H, W, 3) in [0, 1], poses (N, 4, 4)
camera-to-world (OpenGL), focal, and optionally teacher features
(N, hf, wf, D), cls_attn (N, heads, hf, wf) or (N, hf, wf) and depth
(N, H, W). `SceneDataset` lists a directory's `*.npz` and splits them by
index stride: every `val_every`-th file is a val scene.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Scene:
    images: np.ndarray          # (N, H, W, 3) float32 in [0, 1]
    poses: np.ndarray           # (N, 4, 4) camera-to-world (OpenGL)
    focal: float
    features: Optional[np.ndarray] = None   # (N, hf, wf, D) teacher features
    cls_attn: Optional[np.ndarray] = None   # (N, heads, hf, wf)
    depth: Optional[np.ndarray] = None      # (N, H, W)


def save_scene(path: str, scene: Scene) -> None:
    data: Dict[str, np.ndarray] = {
        "images": scene.images, "poses": scene.poses,
        "focal": np.asarray(scene.focal, np.float32)}
    for k in ("features", "cls_attn", "depth"):
        v = getattr(scene, k)
        if v is not None:
            data[k] = v
    np.savez_compressed(path, **data)


def load_scene(path: str) -> Scene:
    with np.load(path) as z:
        return Scene(images=z["images"], poses=z["poses"], focal=float(z["focal"]),
                     features=z["features"] if "features" in z else None,
                     cls_attn=z["cls_attn"] if "cls_attn" in z else None,
                     depth=z["depth"] if "depth" in z else None)


class SceneDataset:
    """All `*.npz` scenes under a root dir; split "train" or "val" by index
    stride (file i is val when i % val_every == val_every - 1). A split
    that would be empty takes every file."""

    def __init__(self, root: str, split: str = "train", val_every: int = 8):
        paths = sorted(glob.glob(os.path.join(root, "*.npz")))
        if not paths:
            raise FileNotFoundError(f"no scene npz files under {root}")
        sel: List[str] = [p for i, p in enumerate(paths)
                          if (split == "train") != ((i % val_every) == (val_every - 1))]
        self.paths = sel or paths

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> Scene:
        return load_scene(self.paths[i])


def synthesize_scene_npz(path: str, n_views: int = 8, hw=(60, 80),
                         seed: int = 0, d_feature: int = 16) -> Scene:
    """Splat the synthetic scene from a camera arc (focal 0.7 * max(h, w))
    into a scene npz, with random low-dimensional stand-in teacher features
    at (h // 4, w // 4); the JAX package's numpy draws, so the same file."""
    from real_robot_nerf_actor_tpu_torch.data.synthetic import (
        make_camera_arc, make_synthetic_scene)
    from real_robot_nerf_actor_tpu_torch.train.nerfact import _splat_view

    h, w = hw
    scene3d = make_synthetic_scene(seed=seed)
    poses = make_camera_arc(n_views)
    focal = 0.7 * max(h, w)
    images = np.stack([_splat_view(scene3d, poses[i], h, w, focal) for i in range(n_views)])
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n_views, h // 4, w // 4, d_feature)).astype(np.float32) * 0.02
    sc = Scene(images=images.astype(np.float32), poses=poses.astype(np.float32),
               focal=focal, features=feats)
    save_scene(path, sc)
    return sc
