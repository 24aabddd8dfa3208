"""Synthetic scene, keyframe demos and exact views (counterpart of the JAX
package's `data/synthetic.py`).

A table plane plus a few coloured boxes inside the scene bounds; a
grasp-like keyframe trajectory above box 0, or one of the language tasks of
`TASK_INSTRUCTIONS`; raytraced ground-truth views of the analytic scene and
deterministic teacher features for them (what `data/kitchen.py` records).
The same numpy draws and arithmetic as the JAX package, so both packages
produce the same arrays for the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from real_robot_nerf_actor_tpu_torch.data.keyframes import KeyframeDemo
from real_robot_nerf_actor_tpu_torch.data.replay import PointCloudSample, ReplayStep


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
# green, box 2 blue.
TASK_INSTRUCTIONS = (
    "grasp the red box and lift it up",
    "grasp the green box and lift it up",
    "press down on the blue box and return home",
)

_HOME = np.array([0.35, 0.2, 0.30], np.float32)


def make_task_demo(scene: SyntheticScene, task: int, seed: int = 0,
                   home_seed: Optional[int] = None) -> KeyframeDemo:
    """5-keyframe demo of task `task` in `scene`. home_seed sets the home
    pose's jitter: the same value for every task of one (kitchen, demo)
    makes keyframe 0 identical across tasks. Tasks 0/1: grasp box 0/1 and
    lift it (approach, descend, close, retreat with the object); task 2:
    press box 2 with a closed gripper and return home."""
    rng = np.random.default_rng(seed)
    hrng = np.random.default_rng(seed if home_seed is None else home_seed)
    home = (_HOME + hrng.normal(0, 0.01, 3)).astype(np.float32)
    jit = lambda: rng.normal(0, 0.008, 3).astype(np.float32)  # noqa: E731
    if task in (0, 1):
        box = scene.box_centers[task]
        waypoints = np.stack([
            home,
            box + np.array([0, 0, 0.12], np.float32) + jit(),
            box + np.array([0, 0, 0.03], np.float32) + jit(),
            box + np.array([0, 0, 0.03], np.float32),
            box + np.array([0, 0, 0.30], np.float32) + jit(),
        ]).astype(np.float32)
        grip = np.array([1, 1, 1, 0, 0], np.float32)
    elif task == 2:
        box = scene.box_centers[2]
        # the lift clears to +0.25, above the approach's +0.15: equal heights
        # with the gripper closed at both would give two transitions the
        # same input and targets 50 voxels apart
        waypoints = np.stack([
            home,
            box + np.array([0, 0, 0.15], np.float32) + jit(),
            box + np.array([0, 0, 0.05], np.float32) + jit(),
            box + np.array([0, 0, 0.25], np.float32) + jit(),
            home + np.array([0.05, 0.0, 0.0], np.float32),
        ]).astype(np.float32)
        grip = np.array([1, 0, 0, 0, 1], np.float32)
    else:
        raise ValueError(f"unknown task {task} (have {len(TASK_INSTRUCTIONS)})")
    rot = np.tile(np.array([[180.0, 0.0, 0.0]], np.float32), (5, 1))
    rot += rng.normal(0, 2.0, rot.shape).astype(np.float32)
    return KeyframeDemo(xyz=waypoints, rotation=rot, gripper_open=grip)


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


def box_surface_points(center: np.ndarray, half: np.ndarray, n: int,
                       rng: np.random.Generator) -> np.ndarray:
    """Points on an axis-aligned box's surface (make_synthetic_scene's
    construction of its boxes)."""
    face = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    p = rng.uniform(-1, 1, (n, 3)) * half
    p[np.arange(n), face] = sign * half[face]
    return (center + p).astype(np.float32)


GRIPPER_HALF = np.array([0.025, 0.025, 0.04], np.float32)
GRIPPER_COLOR = np.array([0.7, 0.7, 0.72], np.float32)


def add_gripper_blob(scene: SyntheticScene, kf_xyz: np.ndarray, n_points: int = 2000,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The scene's cloud plus a gripper-sized box of points at the keyframe
    pose. Returns (points, colors in [-1, 1])."""
    rng = np.random.default_rng(seed)
    gp = box_surface_points(kf_xyz.astype(np.float32), GRIPPER_HALF, n_points, rng)
    gc = np.tile(GRIPPER_COLOR * 2.0 - 1.0, (n_points, 1)).astype(np.float32)
    return np.concatenate([scene.points, gp]), np.concatenate([scene.colors, gc])


def teacher_embed(hit_xyz: np.ndarray, rgb: np.ndarray, mask: np.ndarray,
                  d_embed: int, seed: int = 7) -> np.ndarray:
    """Deterministic, multi-view consistent teacher features for the
    distillation loss: a fixed random 2-layer MLP of (hit xyz, rgb).

    hit_xyz (..., 3), rgb (..., 3) in [0,1], mask (...) bool. Returns
    (..., d_embed) float32, zero where mask is False."""
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((7, 64)) / np.sqrt(7.0)
    w2 = rng.standard_normal((64, d_embed)) / np.sqrt(64.0)
    feats = np.concatenate([hit_xyz, rgb * 2.0 - 1.0, np.ones((*rgb.shape[:-1], 1))],
                           axis=-1)
    e = np.tanh(feats @ w1) @ w2 * 0.3
    return (e * mask[..., None]).astype(np.float32)


def make_replay_steps(scene: SyntheticScene, demo: KeyframeDemo
                      ) -> List[ReplayStep]:
    obs = PointCloudSample(points=scene.points, colors=scene.colors)
    return [
        ReplayStep(observation=obs, proprio_xyz=demo.xyz[k],
                   proprio_rot=demo.rotation[k],
                   proprio_grip=float(demo.gripper_open[k]))
        for k in range(demo.num_keyframes)
    ]


def make_camera_arc(n_views: int, center=(0.35, 0.2, 0.1), radius: float = 2.2,
                    height: float = 1.4) -> np.ndarray:
    """(n_views, 4, 4) OpenGL camera poses on an arc around the scene."""
    center = np.asarray(center, np.float32)
    poses = []
    for i in range(n_views):
        ang = 2 * np.pi * i / max(n_views, 1)
        eye = center + np.array([radius * np.cos(ang), radius * np.sin(ang),
                                 height], np.float32)
        poses.append(_look_at(eye, center))
    return np.stack(poses)
