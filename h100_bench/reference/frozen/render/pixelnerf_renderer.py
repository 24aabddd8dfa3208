"""The coarse-to-fine volume renderer of pixelNeRF (the port's
`render/pixelnerf_renderer.py`, without `extract_radiance`).

The coarse pass evaluates the field at stratified samples; the fine pass at
sorted(coarse, importance samples drawn from the coarse weights, samples
around the coarse depth with its gradient stopped). n_fine counts the depth
samples, as in pixelNeRF's renderer: a fine pass takes n_coarse + n_fine
points. With the coord head, each level also returns `<level>_coord`, the
plain mean of the residual over a ray's samples. Every draw comes from
`draws` (coarse_u, fine_u, fine_jitter, fine_depth_eps).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from h100_bench.reference.frozen.ops.compositing import composite
from h100_bench.reference.frozen.ops.sampling import (
    sample_coarse, sample_fine, sample_fine_depth)


@dataclasses.dataclass(frozen=True)
class PixelNerfRendererConfig:
    n_coarse: int = 64
    n_fine: int = 32
    n_fine_depth: int = 16
    depth_std: float = 0.001
    white_bkgd: bool = False
    lindisp: bool = False


def _eval(net, cfg: PixelNerfRendererConfig, enc, rays, z_samp, swap_uv=False):
    latent, poses_w2c, focal, c, image_shape = enc
    r, k = z_samp.shape
    pts = rays[:, None, :3] + z_samp[..., None] * rays[:, None, 3:6]
    dirs = rays[:, None, 3:6].expand(pts.shape)
    out = net(latent, poses_w2c, focal, c, image_shape, pts.reshape(r * k, 3),
              dirs.reshape(r * k, 3), swap_uv=swap_uv)
    comp = composite(z_samp, rays, out["rgb"].reshape(r, k, 3), out["sigma"].reshape(r, k),
                     out["embed"].reshape(r, k, -1), white_bkgd=cfg.white_bkgd)
    return comp, out


def render_rays(net, cfg: PixelNerfRendererConfig, enc, rays: torch.Tensor,
                draws: Mapping[str, torch.Tensor], swap_uv: bool = False) -> dict:
    """rays (R, 8) -> {'coarse': CompositeOut, 'fine': CompositeOut
    [, 'coarse_coord', 'fine_coord']}."""
    z_coarse = sample_coarse(rays, cfg.n_coarse, cfg.lindisp, u=draws["coarse_u"])
    coarse, raw = _eval(net, cfg, enc, rays, z_coarse, swap_uv)
    out = {"coarse": coarse}
    if "coord_residual" in raw:
        out["coarse_coord"] = raw["coord_residual"].reshape(*z_coarse.shape, 3).mean(1)
    if cfg.n_fine > 0:
        samps = [z_coarse]
        if cfg.n_fine - cfg.n_fine_depth > 0:
            samps.append(sample_fine(rays, coarse.weights, cfg.n_fine - cfg.n_fine_depth,
                                     cfg.n_coarse, cfg.lindisp, u=draws["fine_u"],
                                     jitter=draws["fine_jitter"]))
        if cfg.n_fine_depth > 0:
            samps.append(sample_fine_depth(rays, coarse.depth.detach(), cfg.n_fine_depth,
                                           cfg.depth_std, eps=draws["fine_depth_eps"]))
        z_all = torch.sort(torch.cat(samps, -1), -1).values
        out["fine"], raw_f = _eval(net, cfg, enc, rays, z_all, swap_uv)
        if "coord_residual" in raw_f:
            out["fine_coord"] = raw_f["coord_residual"].reshape(*z_all.shape, 3).mean(1)
    return out
