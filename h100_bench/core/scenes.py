"""The traffic's scenes: a copy of the port's synthetic scene generator
(`data/synthetic.py`: a table plane and boxes inside the scene bounds, a
grasp-like keyframe trajectory, raytraced views of the analytic scene), kept
here so that a later change to the program cannot change the traffic; and
the camera orbit the cells look from."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class KeyframeDemo:
    xyz: np.ndarray           # (K, 3)
    rotation: np.ndarray      # (K, 3) degrees
    gripper_open: np.ndarray  # (K,)

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


def _look_at(eye: np.ndarray, target: np.ndarray, up=(0, 0, 1.0)) -> np.ndarray:
    """OpenGL camera-to-world pose: camera looks down -z toward target."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    z = -fwd
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, y, z, eye
    return pose


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


# Language-conditioned tasks. Every task of one (kitchen, demo) starts at the
# same home keyframe, so the first transition is decodable only through the
# language tokens. Box colours follow the scene palette: box 0 red, box 1
def _unproj_dirs_np(width: int, height: int, focal: float) -> np.ndarray:
    """Numpy twin of ops.rays' unprojection (the renderer's rays must hit
    the pixels raytraced here): OpenGL convention, unit-norm directions,
    principal point at the centre."""
    ys = np.arange(height, dtype=np.float64) - height * 0.5
    xs = np.arange(width, dtype=np.float64) - width * 0.5
    Y, X = np.meshgrid(ys, xs, indexing="ij")
    d = np.stack([X / focal, -Y / focal, -np.ones_like(X)], axis=-1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


_LIGHT_DIR = np.array([0.3, 0.5, 0.8]) / np.linalg.norm([0.3, 0.5, 0.8])


def raytrace_views(scene: SyntheticScene, poses: np.ndarray, height: int,
                   width: int, focal: float, z_far: float = 4.0,
                   extra_boxes: Optional[Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]] = None):
    """Exact, dense views of the analytic scene: every ray intersected with
    the table plane (bounded to the scene's xy extent) and the axis-aligned
    boxes, Lambertian-shaded, with a mild position texture on the table.

    poses: (V, 4, 4) OpenGL camera-to-world. extra_boxes: optional
    (centers (M,3), halves (M,3), colors (M,3)), e.g. a gripper blob.
    Returns (rgb (V,H,W,3) in [0,1], depth (V,H,W) along the unit ray, z_far
    where nothing is hit, hit_xyz (V,H,W,3) 0 where nothing is hit, mask
    (V,H,W) bool).
    """
    if scene.box_halves is None:
        raise ValueError("the scene lacks its analytic geometry")
    centers = scene.box_centers.astype(np.float64)
    halves = scene.box_halves.astype(np.float64)
    colors = scene.box_colors.astype(np.float64)
    if extra_boxes is not None:
        centers = np.concatenate([centers, np.asarray(extra_boxes[0], np.float64)])
        halves = np.concatenate([halves, np.asarray(extra_boxes[1], np.float64)])
        colors = np.concatenate([colors, np.asarray(extra_boxes[2], np.float64)])
    bmin = scene.bounds[:3].astype(np.float64)
    bmax = scene.bounds[3:].astype(np.float64)

    dirs_cam = _unproj_dirs_np(width, height, focal)        # (H, W, 3)
    out_rgb, out_depth, out_xyz, out_mask = [], [], [], []
    for pose in poses:
        R, t = pose[:3, :3].astype(np.float64), pose[:3, 3].astype(np.float64)
        d = dirs_cam @ R.T                                  # (H, W, 3)
        d = d.reshape(-1, 3)
        o = np.broadcast_to(t, d.shape)
        t_hit = np.full(d.shape[0], np.inf)
        rgb = np.zeros_like(d)
        normal = np.zeros_like(d)

        # the table plane z = table_z, bounded to the scene's xy extent
        dz = d[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            tp = (scene.table_z - o[:, 2]) / dz
        hit_p = o + tp[:, None] * d
        ok = ((tp > 1e-4) & np.isfinite(tp)
              & (hit_p[:, 0] >= bmin[0]) & (hit_p[:, 0] <= bmax[0])
              & (hit_p[:, 1] >= bmin[1]) & (hit_p[:, 1] <= bmax[1]))
        upd = ok & (tp < t_hit)
        t_hit[upd] = tp[upd]
        tex = 0.9 + 0.1 * (np.sin(17.0 * hit_p[upd, 0]) * np.sin(13.0 * hit_p[upd, 1]))
        rgb[upd] = scene.table_color[None, :] * tex[:, None]
        normal[upd] = [0.0, 0.0, 1.0]

        # axis-aligned boxes (slab method)
        for c, hlf, col in zip(centers, halves, colors):
            lo, hi = c - hlf, c + hlf
            with np.errstate(divide="ignore", invalid="ignore"):
                t0 = (lo - o) / d
                t1 = (hi - o) / d
            tmin = np.minimum(t0, t1)
            tmax = np.maximum(t0, t1)
            tn = np.max(tmin, axis=-1)
            tf = np.min(tmax, axis=-1)
            ok = (tn > 1e-4) & (tn <= tf)
            upd = ok & (tn < t_hit)
            t_hit[upd] = tn[upd]
            # the entry face's normal: the axis that attains tn
            axis = np.argmax(tmin[upd], axis=-1)
            n = np.zeros((upd.sum(), 3))
            n[np.arange(len(axis)), axis] = -np.sign(d[upd, axis])
            normal[upd] = n
            rgb[upd] = col

        mask = np.isfinite(t_hit)
        shade = 0.7 + 0.3 * np.clip(normal @ _LIGHT_DIR, 0.0, None)
        rgb = np.clip(rgb * shade[:, None], 0.0, 1.0)
        depth = np.where(mask, t_hit, z_far)
        xyz = np.where(mask[:, None], o + np.nan_to_num(t_hit)[:, None] * d, 0.0)
        out_rgb.append(rgb.reshape(height, width, 3))
        out_depth.append(depth.reshape(height, width))
        out_xyz.append(xyz.reshape(height, width, 3))
        out_mask.append(mask.reshape(height, width))
    return (np.stack(out_rgb).astype(np.float32),
            np.stack(out_depth).astype(np.float32),
            np.stack(out_xyz).astype(np.float32),
            np.stack(out_mask))


def orbit_poses(n: int, center=(0.35, 0.2, 0.1), offset=(0.9, -0.75, 0.85),
                phase: float = 0.0) -> np.ndarray:
    """(n, 4, 4) OpenGL poses looking at `center` from `offset` turned about
    the vertical by phase + 2 pi k / n (the port's serving check looks from
    `offset` itself: 1.45 m away, inside the renderer's 1.2-4.0 m band)."""
    c = np.asarray(center, np.float32)
    r = float(np.hypot(offset[0], offset[1]))
    a0 = float(np.arctan2(offset[1], offset[0])) + phase
    eyes = [c + np.array([r * np.cos(a0 + 2 * np.pi * k / n),
                          r * np.sin(a0 + 2 * np.pi * k / n), offset[2]], np.float32)
            for k in range(n)]
    return np.stack([_look_at(e, c) for e in eyes])


def pad_cloud(points: np.ndarray, colors: np.ndarray, n: int):
    """Zero-pad a cloud to n rows: (points, colors, valid)."""
    k = points.shape[0]
    if k > n:
        raise ValueError(f"{k} points do not fit {n} rows")
    pts = np.zeros((n, 3), np.float32)
    cols = np.zeros((n, 3), np.float32)
    pts[:k], cols[:k] = points, colors
    valid = np.zeros(n, bool)
    valid[:k] = True
    return pts, cols, valid
