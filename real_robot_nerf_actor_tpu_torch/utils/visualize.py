"""Render panels and voxel-grid views as PNG files (counterpart of the JAX
package's `utils/visualize.py`), in numpy, written by `data/png.write_png`:
the card's machine has neither matplotlib nor PIL.

  - `render_panels` / `save_render_panel`: the JAX package's panels in its
    order (gt, the render clipped to [0, 1], the depth min-max normalised
    with non-finite pixels at 1, the embed's first three channels min-max
    normalised), tiled side by side. A 2-D panel goes through the viridis
    table below after min-max scaling, as matplotlib's `imshow` colours it.
    The PSNR goes into a PNG tEXt chunk ("PSNR"), not a title;
  - `voxel_points` / `visualize_voxel_grid`: the JAX package's occupied
    voxels (occupancy > 0.5, a seed-0 subsample above max_points, colours
    (rgb + 1) / 2) drawn as three orthographic projections (along z, y and
    x) with the ground-truth action marked in lime (+) and the predicted
    one in red (x). It returns the image (uint8), not a figure.

A failed write raises.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from real_robot_nerf_actor_tpu_torch.data.png import write_png

# matplotlib's "viridis" at its 256 entries, each channel as round(255 * v)
_VIRIDIS_HEX = (
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e614710634711644713654814674816"
    "6848176948186a481a6c481b6d481c6e481d6f481f7048207148217348237448247548257648267748287848"
    "2979472a7a472c7a472d7b472e7c472f7d46307e46327e46337f463480453581453781453882443983443a83"
    "443b84433d84433e85423f854240864241864142874144874045884046883f47883f48893e49893e4a893e4c"
    "8a3d4d8a3d4e8a3c4f8a3c508b3b518b3b528b3a538b3a548c39558c39568c38588c38598c375a8c375b8d36"
    "5c8d365d8d355e8d355f8d34608d34618d33628d33638d32648e32658e31668e31678e31688e30698e306a8e"
    "2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e2c728e2c738e2b748e2b758e2a768e2a778e2a78"
    "8e29798e297a8e297b8e287c8e287d8e277e8e277f8e27808e26818e26828e26828e25838e25848e25858e24"
    "868e24878e23888e23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d21918c20928c20928c20938c"
    "1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f881fa0881fa1881fa1"
    "871fa28720a38620a48621a58521a68522a78522a88423a98324aa8325ab8225ac8226ad8127ad8128ae8029"
    "af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b32b67a34b67935b77937b87838b9773aba763bbb753dbc74"
    "3fbc7340bd7242be7144bf7046c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8"
    "645cc8635ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d1537ad1517c"
    "d2507fd34e81d34d84d44b86d54989d5488bd6468ed64590d74393d74195d84098d83e9bd93c9dd93ba0da39"
    "a2da37a5db36a8db34aadc32addc30b0dd2fb2dd2db5de2bb8de29bade28bddf26c0df25c2df23c5e021c8e0"
    "20cae11fcde11dd0e11cd2e21bd5e21ad8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51bef"
    "e51cf1e51df4e61ef6e620f8e621fbe723fde725"
)
VIRIDIS = np.frombuffer(bytes.fromhex(_VIRIDIS_HEX), np.uint8).reshape(256, 3)
GAP = 2          # white pixels between panels


def colormap(values: np.ndarray) -> np.ndarray:
    """A 2-D array coloured as `imshow(values, cmap="viridis")` colours it:
    min-max scaled, entry min(floor(256 x), 255); non-finite pixels black.
    Returns (H, W, 3) uint8."""
    v = np.asarray(values, np.float64)
    finite = np.isfinite(v)
    out = np.zeros(v.shape + (3,), np.uint8)
    if not finite.any():
        return out
    lo, hi = v[finite].min(), v[finite].max()
    x = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    idx = np.clip(np.floor(np.where(finite, x, 0.0) * 256), 0, 255).astype(np.int64)
    out[finite] = VIRIDIS[idx[finite]]
    return out


def to_uint8(img: np.ndarray) -> np.ndarray:
    """A panel as (H, W, 3) uint8: 2-D through `colormap`, RGB clipped to
    [0, 1] and rounded."""
    a = np.asarray(img)
    if a.ndim == 2:
        return colormap(a)
    return np.round(np.clip(a.astype(np.float64), 0.0, 1.0) * 255.0).astype(np.uint8)


def tile(images: List[np.ndarray], gap: int = GAP) -> np.ndarray:
    """uint8 (H_i, W_i, 3) images side by side on white, top-aligned."""
    h = max(i.shape[0] for i in images)
    w = sum(i.shape[1] for i in images) + gap * (len(images) - 1)
    out = np.full((h, w, 3), 255, np.uint8)
    x = 0
    for i in images:
        out[:i.shape[0], x:x + i.shape[1]] = i
        x += i.shape[1] + gap
    return out


def render_panels(gt_rgb: np.ndarray, rgb: np.ndarray, depth: Optional[np.ndarray] = None,
                  embed: Optional[np.ndarray] = None) -> List[Tuple[str, np.ndarray]]:
    """(name, array) of each panel, the arrays the JAX package hands to
    `imshow`, in its order."""
    panels = [("gt", gt_rgb), ("render", np.clip(rgb, 0, 1))]
    if depth is not None:
        d = np.asarray(depth)
        finite = np.isfinite(d)
        dn = np.zeros_like(d)
        if finite.any():
            lo, hi = d[finite].min(), d[finite].max()
            dn = np.where(finite, (d - lo) / max(hi - lo, 1e-6), 1.0)
        panels.append(("depth", dn))
    if embed is not None:
        e = np.asarray(embed)
        e3 = e[..., :3] if e.shape[-1] >= 3 else np.repeat(e, 3, -1)[..., :3]
        e3 = (e3 - e3.min()) / max(e3.max() - e3.min(), 1e-6)
        panels.append(("embed", e3))
    return panels


def save_render_panel(save_path: str, gt_rgb: np.ndarray, rgb: np.ndarray,
                      depth: Optional[np.ndarray] = None, embed: Optional[np.ndarray] = None,
                      psnr: Optional[float] = None) -> np.ndarray:
    """Side-by-side gt / render / depth / embed panel, written to save_path
    as a PNG (with the PSNR in a tEXt chunk when given). Returns the image
    written (H, W', 3) uint8."""
    panels = render_panels(gt_rgb, rgb, depth, embed)
    image = tile([to_uint8(a) for _, a in panels])
    text = {"Panels": " ".join(n for n, _ in panels)}
    if psnr is not None:
        text["PSNR"] = f"{float(psnr):.2f}"
    write_png(save_path, image, text=text)
    return image


def voxel_points(voxel_grid: np.ndarray, max_points: int = 20000):
    """The occupied voxels (V, V, V, C) channel-last, occupancy last and
    rgb in channels 3:6: (indices (M, 3), colours (M, 3) in [0, 1]), at
    most max_points of them, picked as the JAX package picks them."""
    occ = voxel_grid[..., -1] > 0.5
    idx = np.argwhere(occ)
    if idx.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(idx.shape[0], max_points, replace=False)
        idx = idx[sel]
    rgb = voxel_grid[idx[:, 0], idx[:, 1], idx[:, 2], 3:6]
    return idx, np.clip((rgb + 1.0) / 2.0, 0, 1)


def _mark(img: np.ndarray, row: int, col: int, size: int, color, diagonal: bool):
    h, w = img.shape[:2]
    for t in range(-size, size + 1):
        for dr, dc in (((t, t), (t, -t)) if diagonal else ((t, 0), (0, t))):
            r, c = row + dr, col + dc
            if 0 <= r < h and 0 <= c < w:
                img[r, c] = color


def visualize_voxel_grid(voxel_grid: np.ndarray, gt_action: Optional[np.ndarray] = None,
                         pred_action: Optional[np.ndarray] = None,
                         save_path: Optional[str] = None, max_points: int = 20000
                         ) -> np.ndarray:
    """The occupied voxels of `voxel_points` seen along z, y and x
    (orthographic; the voxel nearest the viewer on top, s x s pixels a
    voxel, s = max(1, 256 // V)), white background, the actions
    ((3,) voxel indices) marked. Returns the (H, W, 3) uint8 image, also
    written to save_path when given."""
    idx, rgb = voxel_points(voxel_grid, max_points)
    v = voxel_grid.shape[0]
    s = max(1, 256 // v)
    col8 = np.round(rgb * 255).astype(np.uint8)
    views = []
    for a, b, c in ((0, 1, 2), (0, 2, 1), (1, 2, 0)):
        img = np.full((v * s, v * s, 3), 255, np.uint8)
        order = np.argsort(idx[:, c], kind="stable")
        rows, cols = (v - 1 - idx[order, b]) * s, idx[order, a] * s
        for dr in range(s):
            for dc in range(s):
                img[rows + dr, cols + dc] = col8[order]
        for act, color, diag in ((gt_action, (0, 255, 0), False),
                                 (pred_action, (255, 0, 0), True)):
            if act is not None:
                p = np.asarray(act).astype(np.int64)
                _mark(img, int((v - 1 - p[b]) * s + s // 2), int(p[a] * s + s // 2),
                      max(3, v * s // 25), color, diag)
        views.append(img)
    image = tile(views)
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        write_png(save_path, image)
    return image
