"""Coarse/fine volume renderer for the image-conditioned pixelNeRF field
(counterpart of the JAX package's `render/pixelnerf_renderer.py`).

`render_rays` runs the coarse pass on stratified samples, then the fine
pass on sorted(coarse ∪ importance ∪ depth samples). The depth samples
are drawn around the coarse depth with its gradient stopped, as the JAX
renderer stops it. When the field regresses coord residuals, each level
also returns `<level>_coord`: the plain mean of the residual over a ray's
samples (not alpha-composited). `extract_radiance` exports the per-sample
radiance of the coarse pass (the NeRF -> point cloud path).

Spans (`utils/profiling.named_scope`), one each a pass: featurenerf.sample
(the pass's depths: stratified, or importance and depth samples sorted
with the coarse ones) and featurenerf.composite; the field's own spans lie
between them (models/pixelnerf.py).

Draws: every sampler takes its draws from `draws` (coarse_u, fine_u,
fine_jitter, fine_depth_eps; and with the field's aug hooks on,
aug_input_coarse, aug_output_coarse, aug_input_fine, aug_output_fine) or
else from `generator`.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch

from real_robot_nerf_actor_tpu_torch.models.pixelnerf import PixelNerfNet
from real_robot_nerf_actor_tpu_torch.ops.compositing import composite
from real_robot_nerf_actor_tpu_torch.ops.sampling import (
    sample_coarse, sample_fine, sample_fine_depth)
from real_robot_nerf_actor_tpu_torch.utils.profiling import named_scope

# (latent (NS, Hf, Wf, C), poses_w2c (NS, 4, 4), focal (2,), c (2,), (H, W))
Encoded = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class PixelNerfRendererConfig:
    n_coarse: int = 64
    n_fine: int = 32
    n_fine_depth: int = 16
    depth_std: float = 0.001
    white_bkgd: bool = False
    lindisp: bool = False


class PixelNerfRenderer:
    def __init__(self, cfg: PixelNerfRendererConfig, net: PixelNerfNet):
        self.cfg = cfg
        self.net = net

    def _eval(self, enc: Encoded, rays, z_samp, train=False, level="coarse",
              draws=None, generator=None):
        latent, poses_w2c, focal, c, image_shape = enc
        r, k = z_samp.shape
        pts = rays[:, None, :3] + z_samp[..., None] * rays[:, None, 3:6]
        dirs = rays[:, None, 3:6].expand(pts.shape)
        d = draws or {}
        aug = {"input": d.get(f"aug_input_{level}"), "output": d.get(f"aug_output_{level}")}
        out = self.net(latent, poses_w2c, focal, c, image_shape, pts.reshape(r * k, 3),
                       dirs.reshape(r * k, 3), train=train, aug_noise=aug,
                       generator=generator)
        with named_scope("featurenerf.composite"):
            comp = composite(z_samp, rays, out["rgb"].reshape(r, k, 3),
                             out["sigma"].reshape(r, k), out["embed"].reshape(r, k, -1),
                             white_bkgd=self.cfg.white_bkgd)
        return comp, out

    def render_rays(self, enc: Encoded, rays: torch.Tensor,
                    generator: Optional[torch.Generator] = None, train: bool = False,
                    draws: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
        """rays: (R, 8). Returns {'coarse': CompositeOut[, 'fine']
        [, 'coarse_coord', 'fine_coord']}. train=True arms the field's
        Aug-NeRF hooks."""
        c = self.cfg
        d = dict(draws or {})
        with named_scope("featurenerf.sample"):
            z_coarse = sample_coarse(rays, c.n_coarse, c.lindisp, u=d.get("coarse_u"),
                                     generator=generator)
        coarse, raw = self._eval(enc, rays, z_coarse, train, "coarse", d, generator)
        out = {"coarse": coarse}
        if "coord_residual" in raw:
            out["coarse_coord"] = raw["coord_residual"].reshape(*z_coarse.shape, 3).mean(1)
        if c.n_fine > 0:
            with named_scope("featurenerf.sample"):
                samps = [z_coarse]
                if c.n_fine - c.n_fine_depth > 0:
                    samps.append(sample_fine(rays, coarse.weights, c.n_fine - c.n_fine_depth,
                                             c.n_coarse, c.lindisp, u=d.get("fine_u"),
                                             jitter=d.get("fine_jitter"), generator=generator))
                if c.n_fine_depth > 0:
                    samps.append(sample_fine_depth(rays, coarse.depth.detach(), c.n_fine_depth,
                                                   c.depth_std, eps=d.get("fine_depth_eps"),
                                                   generator=generator))
                z_all = torch.sort(torch.cat(samps, -1), -1).values
            out["fine"], raw_f = self._eval(enc, rays, z_all, train, "fine", d, generator)
            if "coord_residual" in raw_f:
                out["fine_coord"] = raw_f["coord_residual"].reshape(*z_all.shape, 3).mean(1)
        return out

    def extract_radiance(self, enc: Encoded, rays: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
        """Per-sample export of the coarse pass: points (R, K, 3), rgb
        (R, K, 3), sigma (R, K), embed (R, K, D), weights (R, K), z (R, K)."""
        c = self.cfg
        z = sample_coarse(rays, c.n_coarse, c.lindisp, u=(draws or {}).get("coarse_u"),
                          generator=generator)
        comp, raw = self._eval(enc, rays, z)
        r, k = z.shape
        return {"points": rays[:, None, :3] + z[..., None] * rays[:, None, 3:6],
                "rgb": raw["rgb"].reshape(r, k, 3), "sigma": raw["sigma"].reshape(r, k),
                "embed": raw["embed"].reshape(r, k, -1), "weights": comp.weights, "z": z}
