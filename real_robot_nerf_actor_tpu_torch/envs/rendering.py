"""GL-free MuJoCo rendering: raycast RGB / depth / segmentation and point
clouds (counterpart of the JAX package's `envs/rendering.py`, host numpy).

The reference system renders depth from every camera through OpenGL and
back-projects it to a fused, bounds-cropped point cloud with intrinsics
from fovy. This renderer casts one MuJoCo ray per pixel instead
(`mj_multiRay`), so it runs headless and gives depth, flat-shaded geom
colour and segmentation in one pass. It is not a kernel: it runs on the
host, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from real_robot_nerf_actor_tpu_torch.envs._deps import require

mujoco = require("mujoco")


def camera_intrinsics(fovy_deg: float, height: int, width: int
                      ) -> np.ndarray:
    """3x3 K from vertical fov (the reference's cammat2o3d math)."""
    f = 0.5 * height / np.tan(np.deg2rad(fovy_deg) / 2.0)
    return np.array([[f, 0, (width - 1) / 2.0],
                     [0, f, (height - 1) / 2.0],
                     [0, 0, 1.0]])


def camera_pose(model: mujoco.MjModel, data: mujoco.MjData, cam_name: str
                ) -> np.ndarray:
    """4x4 camera-to-world pose. MuJoCo camera frames look down -z with
    x right / y up (OpenGL convention)."""
    cid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_CAMERA, cam_name)
    pose = np.eye(4)
    pose[:3, :3] = data.cam_xmat[cid].reshape(3, 3)
    pose[:3, 3] = data.cam_xpos[cid]
    return pose


@dataclasses.dataclass
class RenderOut:
    rgb: np.ndarray      # (H, W, 3) float32 in [0, 1]
    depth: np.ndarray    # (H, W) float32, +inf where no hit
    seg: np.ndarray      # (H, W) int32 geom id, -1 where no hit


class RaycastRenderer:
    """Flat-shaded raycast renderer (one mj_ray per pixel, batched via
    mj_multiRay when available)."""

    def __init__(self, model: mujoco.MjModel, height: int = 64,
                 width: int = 64):
        self.model = model
        self.h = height
        self.w = width

    def _ray_dirs(self, fovy_deg: float) -> np.ndarray:
        k = camera_intrinsics(fovy_deg, self.h, self.w)
        ys, xs = np.meshgrid(np.arange(self.h), np.arange(self.w),
                             indexing="ij")
        x = (xs - k[0, 2]) / k[0, 0]
        y = (ys - k[1, 2]) / k[1, 1]
        # camera looks down -z; y image axis points down -> -y camera
        dirs = np.stack([x, -y, -np.ones_like(x)], axis=-1)
        return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    def render(self, data: mujoco.MjData, cam_name: str,
               light_dir: Tuple[float, float, float] = (0.3, 0.2, -0.9)
               ) -> RenderOut:
        m = self.model
        cid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_CAMERA, cam_name)
        fovy = float(m.cam_fovy[cid])
        pose = camera_pose(m, data, cam_name)
        dirs_cam = self._ray_dirs(fovy).reshape(-1, 3)
        dirs_world = dirs_cam @ pose[:3, :3].T
        origin = pose[:3, 3]

        n = dirs_world.shape[0]
        geomids = np.full(n, -1, np.int32)
        dists = np.full(n, -1.0, np.float64)
        normals = np.zeros(n * 3, np.float64)
        mujoco.mj_multiRay(m, data, origin.astype(np.float64),
                           dirs_world.reshape(-1).astype(np.float64),
                           None, 1, -1, geomids, dists, normals, n, 9999.0)

        hit = (geomids >= 0) & (dists >= 0)
        depth = np.where(hit, dists * (-dirs_cam[:, 2]), np.inf)  # z-depth
        rgb = np.zeros((n, 3), np.float32)
        if hit.any():
            rgba = self.model.geom_rgba[geomids[hit]][:, :3]
            nrm = normals.reshape(n, 3)[hit]
            ld = np.asarray(light_dir) / np.linalg.norm(light_dir)
            lam = 0.45 + 0.55 * np.clip((nrm * -ld).sum(-1), 0, 1)
            rgb[hit] = rgba * lam[:, None]
        return RenderOut(rgb=rgb.reshape(self.h, self.w, 3),
                         depth=depth.reshape(self.h, self.w).astype(np.float32),
                         seg=geomids.reshape(self.h, self.w))

    def pointcloud(self, data: mujoco.MjData, cam_name: str,
                   max_depth: float = 5.0) -> Tuple[np.ndarray, np.ndarray]:
        """Back-project one camera's depth to world points + colors."""
        out = self.render(data, cam_name)
        m = self.model
        cid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_CAMERA, cam_name)
        pose = camera_pose(m, data, cam_name)
        dirs_cam = self._ray_dirs(float(m.cam_fovy[cid])).reshape(-1, 3)
        depth = out.depth.reshape(-1)
        keep = np.isfinite(depth) & (depth < max_depth)
        # depth is z-depth; point = origin + dir * (depth / -dir_z)
        t = depth[keep] / (-dirs_cam[keep, 2])
        pts_cam = dirs_cam[keep] * t[:, None]
        pts = pts_cam @ pose[:3, :3].T + pose[:3, 3]
        return pts.astype(np.float32), out.rgb.reshape(-1, 3)[keep]


class PointCloudGenerator:
    """Fused multi-camera point cloud, cropped to bounds (the reference's
    PointCloudGenerator API)."""

    def __init__(self, model: mujoco.MjModel, cam_names, height=64, width=64,
                 bounds: Optional[np.ndarray] = None):
        self.renderer = RaycastRenderer(model, height, width)
        self.cam_names = list(cam_names)
        self.bounds = bounds

    def generate(self, data: mujoco.MjData) -> Tuple[np.ndarray, np.ndarray]:
        pts_all, col_all = [], []
        for cam in self.cam_names:
            p, c = self.renderer.pointcloud(data, cam)
            pts_all.append(p)
            col_all.append(c)
        pts = np.concatenate(pts_all)
        cols = np.concatenate(col_all)
        if self.bounds is not None:
            b = self.bounds
            keep = ((pts >= b[:3]).all(-1) & (pts <= b[3:]).all(-1))
            pts, cols = pts[keep], cols[keep]
        return pts, cols
