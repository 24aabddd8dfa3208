"""RealSense-style depth post-processing as array math on the host
(counterpart of the JAX package's `data/depth_filters.py`, which is numpy
too; the port keeps its own copy, bit-equal to it).

The reference's chain (read_real_data_kitchen.py:55-115): depth ->
disparity -> spatial_filter(magnitude=5, smooth_alpha=0.75, smooth_delta=1,
holes_fill=1) -> temporal_filter -> disparity -> depth -> pointcloud,
clipped at 1 m. The filters' published semantics, in numpy float32:

  - disparity transform: d = k / depth with a fixed scale k (invalid
    depth 0 stays 0 in both domains);
  - spatial filter: `magnitude` iterations of the one-dimensional
    edge-preserving exponential smoother, run left->right, right->left,
    top->bottom, bottom->top; a pixel is smoothed toward its predecessor
    only where |disparity step| <= delta (edges are preserved), and
    holes_fill=r additionally copies the running value into invalid
    pixels up to r consecutive steps;
  - temporal filter: per-pixel EMA against the previous FILTERED frame
    where |change| <= delta, reset to the new value where the change is
    larger, with a persistence rule filling current holes from history.

The spatial scan is some 11,000 dependent row steps on a 480 x 640 frame
(5 x (2 x 640 + 2 x 480)); on a card each would be a launch, so the
filters stay on the host. `depth_to_pointcloud` runs on the device the
caller names. The temporal filter's state is carried explicitly
(`TemporalState`); `DepthFilterPipeline` holds it between frames.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SpatialFilterConfig:
    magnitude: int = 5           # smoothing iterations (rs filter_magnitude)
    smooth_alpha: float = 0.75   # EMA weight of the running value
    smooth_delta: float = 1.0    # max disparity step treated as same surface
    holes_fill: int = 1          # fill invalid runs up to this length


@dataclasses.dataclass(frozen=True)
class TemporalFilterConfig:
    smooth_alpha: float = 0.4    # rs defaults
    smooth_delta: float = 20.0
    persistence: int = 3         # frames a stale value survives in holes


def depth_to_disparity(depth: np.ndarray, k: float = 1.0) -> np.ndarray:
    """depth (m) -> disparity (k/depth); 0 (invalid) stays 0."""
    depth = np.asarray(depth, np.float32)
    out = np.zeros_like(depth)
    valid = depth > 0
    out[valid] = k / depth[valid]
    return out


def disparity_to_depth(disp: np.ndarray, k: float = 1.0) -> np.ndarray:
    return depth_to_disparity(disp, k)   # involution


def _smooth_rows(disp: np.ndarray, cfg: SpatialFilterConfig,
                 reverse: bool) -> np.ndarray:
    """One left->right (or right->left) edge-preserving pass, vectorized
    over rows: a sequential scan along the column axis."""
    a, delta, r = cfg.smooth_alpha, cfg.smooth_delta, cfg.holes_fill
    x = disp[:, ::-1] if reverse else disp
    out = x.copy()
    run = out[:, 0].copy()           # running smoothed value per row
    hole = np.zeros(x.shape[0], np.int32)
    for j in range(1, x.shape[1]):
        v = x[:, j]
        valid = v > 0
        near = valid & (np.abs(v - run) <= delta) & (run > 0)
        # smooth toward the running value on the same surface
        sm = a * run + (1.0 - a) * v
        newrun = np.where(near, sm, np.where(valid, v, run))
        fill = (~valid) & (hole < r) & (run > 0)
        out[:, j] = np.where(near, sm, np.where(valid, v,
                             np.where(fill, run, 0.0)))
        hole = np.where(valid, 0, hole + 1)
        run = newrun
    return out[:, ::-1] if reverse else out


def spatial_filter(disp: np.ndarray,
                   cfg: SpatialFilterConfig = SpatialFilterConfig()
                   ) -> np.ndarray:
    """Edge-preserving spatial smoothing in the DISPARITY domain
    (librealsense spatial_filter semantics)."""
    out = np.asarray(disp, np.float32).copy()
    for _ in range(max(1, cfg.magnitude)):
        out = _smooth_rows(out, cfg, reverse=False)
        out = _smooth_rows(out, cfg, reverse=True)
        out = _smooth_rows(out.T, cfg, reverse=False).T
        out = _smooth_rows(out.T, cfg, reverse=True).T
    return out


@dataclasses.dataclass
class TemporalState:
    value: np.ndarray            # last filtered disparity
    age: np.ndarray              # frames since the pixel was last valid


def temporal_filter(disp: np.ndarray, state: Optional[TemporalState],
                    cfg: TemporalFilterConfig = TemporalFilterConfig()
                    ) -> Tuple[np.ndarray, TemporalState]:
    """Per-pixel EMA across frames with edge reset + hole persistence."""
    disp = np.asarray(disp, np.float32)
    if state is None:
        return disp.copy(), TemporalState(
            value=disp.copy(),
            age=np.where(disp > 0, 0, 10 ** 6).astype(np.int32))
    prev, age = state.value, state.age
    valid = disp > 0
    had = prev > 0
    near = valid & had & (np.abs(disp - prev) <= cfg.smooth_delta)
    sm = cfg.smooth_alpha * disp + (1.0 - cfg.smooth_alpha) * prev
    out = np.where(near, sm, np.where(valid, disp, 0.0))
    # persistence: fill current holes from recent history
    persist = (~valid) & had & (age < cfg.persistence)
    out = np.where(persist, prev, out)
    new_value = np.where(out > 0, out, prev)
    new_age = np.where(valid, 0, age + 1).astype(np.int32)
    return out, TemporalState(value=new_value, age=new_age)


@dataclasses.dataclass
class DepthFilterPipeline:
    """The reference's exact chain (read_real_data_kitchen.py:55-115):
    depth -> disparity -> spatial -> temporal -> depth -> clip."""

    spatial: SpatialFilterConfig = dataclasses.field(
        default_factory=SpatialFilterConfig)
    temporal: TemporalFilterConfig = dataclasses.field(
        default_factory=TemporalFilterConfig)
    clip_m: float = 1.0          # clipping_distance_in_meters
    disparity_k: float = 1.0
    _state: Optional[TemporalState] = None

    def reset(self):
        self._state = None

    def __call__(self, depth_m: np.ndarray) -> np.ndarray:
        disp = depth_to_disparity(depth_m, self.disparity_k)
        disp = spatial_filter(disp, self.spatial)
        disp, self._state = temporal_filter(disp, self._state, self.temporal)
        depth = disparity_to_depth(disp, self.disparity_k)
        if self.clip_m > 0:
            depth = np.where(depth > self.clip_m, 0.0, depth)
        return depth


def depth_to_pointcloud(depth_m, intrinsics: np.ndarray, device=None):
    """Perspective depth (H, W) -> (H, W, 3) camera-frame points
    (read_real_data_kitchen.py get_pointcloud, :144-160). With `device`
    (a torch device or its name) the points are computed there, in
    float32, and returned as a tensor (CUDA raises where there is none);
    else as a numpy array."""
    if device is None:
        h, w = depth_m.shape
        px, py = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32))
        x = (px - intrinsics[0, 2]) * (depth_m / intrinsics[0, 0])
        y = (py - intrinsics[1, 2]) * (depth_m / intrinsics[1, 1])
        return np.stack([x, y, depth_m], axis=-1).astype(np.float32)
    from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device
    depth = torch.as_tensor(depth_m, dtype=torch.float32).to(resolve_device(device))
    h, w = depth.shape
    k = np.asarray(intrinsics, np.float64)
    py, px = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=depth.device),
                            torch.arange(w, dtype=torch.float32, device=depth.device),
                            indexing="ij")
    x = (px - float(k[0, 2])) * (depth / float(k[0, 0]))
    y = (py - float(k[1, 2])) * (depth / float(k[1, 1]))
    return torch.stack([x, y, depth], dim=-1)
