"""NeRF -> geometry extraction (the port's copy of the JAX package's
`eval/extract.py`): sigma-thresholded feature point clouds and meshes.

The threshold search is exact (a sort), the point cloud a mask over the
per-sample radiance export (PixelNerfRenderer.extract_radiance), and the
mesh scikit-image's marching cubes where it imports, else the midpoints of
the grid's sign-change edges (vertices only).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def sigma_threshold_search(sigmas: np.ndarray, target_min: int = 50000,
                           target_max: int = 70000) -> float:
    """A sigma threshold so that #(sigma > t) lands in [target_min,
    target_max], or as close as the count of samples allows."""
    flat = np.sort(np.asarray(sigmas).reshape(-1))[::-1]
    n = flat.shape[0]
    if n <= target_min:
        return float(flat[-1]) - 1e-6 if n else 0.0
    k = min(max(target_min, min(target_max, n // 2)), n - 1)
    return float(flat[k])


def extract_nerf_pointcloud(points: np.ndarray, rgbs: np.ndarray,
                            sigmas: np.ndarray, embeds: np.ndarray,
                            base_from_world: Optional[np.ndarray] = None,
                            brightness_min: float = 0.03,
                            target_min: int = 50000, target_max: int = 70000
                            ) -> Dict[str, np.ndarray]:
    """Filter per-sample radiance (points (N, 3), rgbs (N, 3) in [0, 1],
    sigmas (N,), embeds (N, D)) into a feature point cloud: mean rgb above
    brightness_min and sigma above `sigma_threshold_search` of the bright
    samples; points optionally moved to the robot base frame."""
    points = np.asarray(points).reshape(-1, 3)
    rgbs = np.asarray(rgbs).reshape(-1, 3)
    sigmas = np.asarray(sigmas).reshape(-1)
    embeds = np.asarray(embeds).reshape(sigmas.shape[0], -1)
    bright = rgbs.mean(-1) > brightness_min
    thr = sigma_threshold_search(sigmas[bright], target_min, target_max)
    keep = bright & (sigmas > thr)
    pts = points[keep]
    if base_from_world is not None:
        pts = pts @ base_from_world[:3, :3].T + base_from_world[:3, 3]
    return {"points": pts, "rgbs": rgbs[keep], "sigmas": sigmas[keep],
            "embeds": embeds[keep], "threshold": np.float64(thr)}


def extract_mesh(sigma_grid: np.ndarray, threshold: float,
                 origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """sigma_grid (X, Y, Z) -> (vertices (M, 3), faces (K, 3) or None)."""
    try:
        from skimage import measure
        verts, faces, _, _ = measure.marching_cubes(
            np.asarray(sigma_grid, np.float32), level=threshold, spacing=spacing)
        return verts + np.asarray(origin), faces
    except Exception:
        g = np.asarray(sigma_grid) > threshold
        verts = []
        for axis in range(3):
            a = np.swapaxes(g, 0, axis)
            idx = np.argwhere(a[:-1] ^ a[1:])
            if idx.size == 0:
                continue
            mid = idx.astype(np.float64)
            mid[:, 0] += 0.5
            mid[:, [0, axis]] = mid[:, [axis, 0]]
            verts.append(mid)
        if not verts:
            return np.zeros((0, 3)), None
        return np.concatenate(verts) * np.asarray(spacing) + np.asarray(origin), None


def sample_sigma_grid(render_sigma_fn, bounds: np.ndarray, resolution: int = 64,
                      chunk: int = 65536) -> np.ndarray:
    """sigma(x) over a dense grid inside bounds (xmin, ymin, zmin, xmax,
    ymax, zmax); render_sigma_fn maps (N, 3) points to (N,) sigmas."""
    lo, hi = np.asarray(bounds[:3]), np.asarray(bounds[3:])
    axes = [np.linspace(lo[i], hi[i], resolution) for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    out = np.empty(pts.shape[0], np.float32)
    for s in range(0, pts.shape[0], chunk):
        out[s:s + chunk] = np.asarray(render_sigma_fn(pts[s:s + chunk]))
    return out.reshape(resolution, resolution, resolution)
