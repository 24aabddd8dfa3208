"""Camera ray generation and NeRF positional encoding (counterpart of the
JAX package's `ops/rays.py`).

Ray layout is the reference's 8-dim convention:
  [origin(3), direction(3), near(1), far(1)].
"""
from __future__ import annotations

import dataclasses

import torch


def unproj_map(width: int, height: int, focal, c=None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-pixel unit ray directions in the camera frame (OpenGL convention:
    +x right, +y up, camera looks down -z). Returns (H, W, 3)."""
    focal = torch.as_tensor(focal, dtype=dtype, device=device)
    if focal.dim() == 0:
        fx = fy = focal
    else:
        focal = focal.reshape(-1)
        fx, fy = (focal[0], focal[0]) if focal.shape[0] == 1 else (focal[0], focal[1])
    if c is None:
        cx, cy = width * 0.5, height * 0.5
    else:
        c = torch.as_tensor(c, dtype=dtype, device=device).reshape(-1)
        cx, cy = c[0], c[1]
    ys = torch.arange(height, dtype=dtype, device=device) - cy
    xs = torch.arange(width, dtype=dtype, device=device) - cx
    y, x = torch.meshgrid(ys, xs, indexing="ij")
    x = x / fx
    y = y / fy
    d = torch.stack([x, -y, -torch.ones_like(x)], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def gen_rays(poses: torch.Tensor, width: int, height: int, focal,
             z_near: float, z_far: float, c=None) -> torch.Tensor:
    """Camera rays for each pixel of each pose.

    poses: (B, 4, 4) camera-to-world (OpenGL).
    Returns (B, H, W, 8): [origin, direction, near, far].
    """
    dirs_cam = unproj_map(width, height, focal, c=c, dtype=poses.dtype,
                          device=poses.device)
    dirs_world = torch.einsum("bij,hwj->bhwi", poses[:, :3, :3], dirs_cam)
    origins = poses[:, None, None, :3, 3].expand(dirs_world.shape)
    near = torch.full(dirs_world.shape[:-1] + (1,), z_near, dtype=poses.dtype,
                      device=poses.device)
    far = torch.full_like(near, z_far)
    return torch.cat([origins, dirs_world, near, far], dim=-1)


@dataclasses.dataclass(frozen=True)
class PositionalEncodingSpec:
    """NeRF sinusoidal positional encoding: freqs freq_factor * 2**i, the
    (sin, cos) pair of each frequency over the whole d_in block, optionally
    after the raw input."""

    num_freqs: int = 6
    d_in: int = 3
    freq_factor: float = 1.5
    include_input: bool = True

    @property
    def d_out(self) -> int:
        d = self.num_freqs * 2 * self.d_in
        return d + self.d_in if self.include_input else d


def positional_encoding(x: torch.Tensor, spec: PositionalEncodingSpec) -> torch.Tensor:
    """x: (..., d_in) -> (..., spec.d_out), laid out
    [x?, sin(f0*x), cos(f0*x), sin(f1*x), cos(f1*x), ...]."""
    freqs = spec.freq_factor * (2.0 ** torch.arange(
        spec.num_freqs, dtype=x.dtype, device=x.device))
    scaled = x[..., None, :] * freqs[:, None]
    enc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], spec.num_freqs * 2 * spec.d_in)
    if spec.include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
