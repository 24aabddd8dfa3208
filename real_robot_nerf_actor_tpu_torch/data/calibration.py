"""Hand-eye calibration and heightmap utilities, numpy only (the port's copy
of the JAX package's `data/calibration.py`).

The camera-to-base chain is cam2base = inv(desk2camera @ adjust_ori @
adjust_pos) @ gl2cv; calibration is data (a JSON file), not constants.
"""
from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np


def euler_to_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Intrinsic xyz euler -> 3x3 rotation (transforms3d's euler2mat 'sxyz')."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def gl_to_cv() -> np.ndarray:
    """OpenGL -> OpenCV camera-frame flip (a rotation of pi about x)."""
    m = np.eye(4)
    m[:3, :3] = euler_to_matrix(np.pi, 0.0, 0.0)
    return m


def compose_cam2base(desk2camera: np.ndarray,
                     adjust_ori: Optional[np.ndarray] = None,
                     adjust_pos: Optional[np.ndarray] = None,
                     apply_gl2cv: bool = True) -> np.ndarray:
    """base2camera = desk2camera @ adjust_ori @ adjust_pos;
    cam2base = inv(base2camera) [@ gl2cv]."""
    base2camera = np.asarray(desk2camera, np.float64)
    if adjust_ori is not None:
        base2camera = base2camera @ adjust_ori
    if adjust_pos is not None:
        base2camera = base2camera @ adjust_pos
    cam2base = np.linalg.inv(base2camera)
    if apply_gl2cv:
        cam2base = cam2base @ gl_to_cv()
    return cam2base


def save_calibration(path: str, cam2base: np.ndarray, **extra) -> None:
    data = {"cam2base": np.asarray(cam2base).tolist()}
    data.update({k: np.asarray(v).tolist() for k, v in extra.items()})
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def load_calibration(path: str) -> np.ndarray:
    with open(path) as f:
        return np.asarray(json.load(f)["cam2base"], np.float64)


def get_heightmap(points: np.ndarray, colors: Optional[np.ndarray],
                  bounds: np.ndarray, pixel_size: float
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Top-down orthographic heightmap and colormap of a point cloud: the
    highest point of each xy cell inside bounds, z-buffered."""
    bounds = np.asarray(bounds, np.float64).reshape(2, 3)  # [[min],[max]]
    w = int(np.round((bounds[1, 0] - bounds[0, 0]) / pixel_size))
    h = int(np.round((bounds[1, 1] - bounds[0, 1]) / pixel_size))
    heightmap = np.zeros((h, w), np.float32)
    colormap = np.zeros((h, w, 3), np.float32) if colors is not None else None

    keep = ((points[:, 0] >= bounds[0, 0]) & (points[:, 0] < bounds[1, 0])
            & (points[:, 1] >= bounds[0, 1]) & (points[:, 1] < bounds[1, 1])
            & (points[:, 2] >= bounds[0, 2]) & (points[:, 2] < bounds[1, 2]))
    pts = points[keep]
    cols = colors[keep] if colors is not None else None
    px = ((pts[:, 0] - bounds[0, 0]) / pixel_size).astype(np.int32)
    py = ((pts[:, 1] - bounds[0, 1]) / pixel_size).astype(np.int32)
    order = np.argsort(pts[:, 2])  # low to high: the highest is written last
    px, py = px[order], py[order]
    hz = (pts[order, 2] - bounds[0, 2]).astype(np.float32)
    heightmap[py, px] = hz
    if colormap is not None:
        colormap[py, px] = cols[order]
    return heightmap, colormap
