"""Posed multi-view scenes for a pixel-aligned field: the traffic's scenes
(`scenes.make_synthetic_scene`: a table and boxes in the workspace)
raytraced from a ring of cameras around the workspace, as a FeatureNeRF
scene dataset holds them (images in [0, 1], OpenGL camera-to-world poses,
one focal), with each view's bbox of the pixels that see the scene
(cmin, rmin, cmax, rmax), as pixelNeRF's `bbox_sample` takes it."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from h100_bench.core import scenes, traffic


def bboxes(mask: np.ndarray) -> np.ndarray:
    """(V, 4) int64 (cmin, rmin, cmax, rmax) of each view's True pixels; the
    whole view where none is."""
    out = []
    for m in mask:
        rows, cols = np.nonzero(m.any(1))[0], np.nonzero(m.any(0))[0]
        if rows.size == 0:
            out.append((0, 0, m.shape[1] - 1, m.shape[0] - 1))
        else:
            out.append((cols[0], rows[0], cols[-1], rows[-1]))
    return np.asarray(out, np.int64)


def posed_scenes(t: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """t["scenes"] scenes of t["views"] views each: a scene drawn from the
    seed, looked at from t["orbit"]'s ring (its `center`, and `offset` from
    it turned about the vertical) at an angle drawn from the seed.
    Returns images (V, H, W, 3), poses (V, 4, 4), bbox (V, 4), depth (V, H, W)
    along the unit ray (inf where nothing is hit)."""
    rng = traffic.host_rng(seed)
    h, w = t["view"]
    out = []
    for _ in range(t["scenes"]):
        sc = scenes.make_synthetic_scene(seed=int(rng.integers(2 ** 31)),
                                         n_points=t["scene_points"], bounds=tuple(t["bounds"]))
        poses = scenes.orbit_poses(t["views"], center=tuple(t["orbit"]["center"]),
                                   offset=tuple(t["orbit"]["offset"]),
                                   phase=float(rng.uniform(0, 2 * np.pi)))
        rgb, depth, _, mask = scenes.raytrace_views(sc, poses, h, w, t["focal"])
        out.append({"images": rgb, "poses": poses.astype(np.float32), "bbox": bboxes(mask),
                    "depth": np.where(mask, depth, np.inf).astype(np.float32)})
    return out
