"""FeatureNeRF's training objective and its pixel draws (the port's
`train/featurenerf.py`, cut to the step's forward: its own pixel sampling,
the encode, the render and the losses; no data feed, no optimizer).

FeatureNeRF (Ye et al., arXiv:2303.12786), as the source repository's
`train_embed.py` trains it:

  - rays: a view per ray and a pixel in it, inside the view's bbox
    (cmin, rmin, cmax, rmax) while step < no_bbox_step and the scene has
    bboxes (pixelNeRF's `bbox_sample`);
  - the source views `src_ord` encoded in inference mode;
  - loss = lambda_coarse * MSE(rgb coarse) + lambda_fine * MSE(rgb fine)
    + lambda_embed * (MSE(embed coarse) + MSE(embed fine)) against the
    teacher features sampled at the ray pixels, + lambda_coord *
    (MSE(coord residual coarse, 0) + MSE(.. fine, 0)). The cls-attention
    term is refused (the configuration sets lambda_attn 0), and so, as an
    unknown key, is mask_feat (the configuration leaves it off).

Departure: the teacher map is sampled as `F.grid_sample(...,
align_corners=False)` with zero padding, each axis normalised by its own
size; the source divides both by (H, W), the same for square views.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from h100_bench.reference.frozen.models.pixelnerf import PixelNerfConfig
from h100_bench.reference.frozen.ops.rays import gen_rays
from h100_bench.reference.frozen.render.pixelnerf_renderer import (
    PixelNerfRendererConfig, render_rays)


@dataclasses.dataclass(frozen=True)
class FeatureNerfConfig:
    model: PixelNerfConfig = dataclasses.field(default_factory=PixelNerfConfig)
    renderer: PixelNerfRendererConfig = dataclasses.field(
        default_factory=PixelNerfRendererConfig)
    ray_batch_size: int = 512
    z_near: float = 1.2
    z_far: float = 4.0
    lambda_coarse: float = 1.0
    lambda_fine: float = 1.0
    lambda_embed: float = 0.1
    lambda_attn: float = 0.1
    lambda_coord: float = 0.0
    no_bbox_step: int = 100_000
    nviews: Tuple[int, ...] = (1,)


def sample_pixels(cfg: FeatureNerfConfig, bbox: Optional[torch.Tensor], step: int,
                  d: Dict[str, torch.Tensor]):
    """(v, y, x) of the step's rays from its draws (v, y, x, u_bbox):
    inside the view's bbox while step < no_bbox_step, where there are
    bboxes."""
    v, y, x = d["v"].long(), d["y"].long(), d["x"].long()
    if bbox is not None and cfg.no_bbox_step > 0 and step < cfg.no_bbox_step:
        bb = bbox[v].to(torch.float32)
        ub = d["u_bbox"]
        x = (ub[:, 0] * (bb[:, 2] + 1 - bb[:, 0]) + bb[:, 0]).long()
        y = (ub[:, 1] * (bb[:, 3] + 1 - bb[:, 1]) + bb[:, 1]).long()
    return v, y, x


def sample_view_maps(maps: torch.Tensor, v, y, x, image_shape: Tuple[int, int]):
    """maps (NV, hf, wf, C) at pixels (v, y, x) of (H, W) views -> (R, C):
    `F.grid_sample`'s bilinear, align_corners=False, zero padding."""
    h, w = image_shape
    _, hf, wf, _ = maps.shape
    yf = y.to(torch.float32) / h * hf - 0.5
    xf = x.to(torch.float32) / w * wf - 0.5
    y0, x0 = torch.floor(yf), torch.floor(xf)
    ty, tx = (yf - y0)[:, None], (xf - x0)[:, None]

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < hf) & (xi >= 0) & (xi < wf)
        return maps[v, yi.clamp(0, hf - 1).long(), xi.clamp(0, wf - 1).long()] \
            * inside[:, None].to(maps.dtype)

    v0 = tap(y0, x0) * (1 - tx) + tap(y0, x0 + 1) * tx
    v1 = tap(y0 + 1, x0) * (1 - tx) + tap(y0 + 1, x0 + 1) * tx
    return v0 * (1 - ty) + v1 * ty


def losses(net, cfg: FeatureNerfConfig, batch: Dict[str, torch.Tensor], v, y, x,
           src_ord: torch.Tensor, render_draws: Dict[str, torch.Tensor],
           fault: Optional[str] = None) -> torch.Tensor:
    """The step's total loss. fault: a planted fault ("swap_uv": u and v
    exchanged before the latent lookup; "other_view": the latent of the view
    after each source view, posed as the source; "targets_xy_swapped": the
    teacher targets sampled at (x, y) for (y, x))."""
    if cfg.lambda_attn > 0:
        raise ValueError("the reference leaves the attention term out")
    images, poses, focal = batch["images"], batch["poses"], batch["focal"]
    nv, h, w, _ = images.shape
    enc_ord = (src_ord + 1) % nv if fault == "other_view" else src_ord
    latent = net.encode(images[enc_ord] * 2.0 - 1.0)
    f = torch.as_tensor(focal, dtype=torch.float32, device=images.device)
    enc = (latent, torch.linalg.inv(poses[src_ord]), torch.stack([f, -f]),
           torch.zeros(2, device=images.device), (h, w))
    rays = gen_rays(poses, w, h, focal, cfg.z_near, cfg.z_far)[v, y, x]
    out = render_rays(net, cfg.renderer, enc, rays, render_draws,
                      swap_uv=fault == "swap_uv")
    coarse, fine = out["coarse"], out.get("fine", out["coarse"])
    gt_rgb = images[v, y, x]
    loss = (cfg.lambda_coarse * torch.mean((coarse.rgb - gt_rgb) ** 2)
            + cfg.lambda_fine * torch.mean((fine.rgb - gt_rgb) ** 2))
    if cfg.lambda_embed > 0 and "features" in batch:
        ty, tx = (x, y) if fault == "targets_xy_swapped" else (y, x)
        gt_embed = sample_view_maps(batch["features"], v, ty, tx, (h, w))
        loss = loss + cfg.lambda_embed * (torch.mean((coarse.embed - gt_embed) ** 2)
                                          + torch.mean((fine.embed - gt_embed) ** 2))
    if cfg.lambda_coord > 0:
        fine_coord = out.get("fine_coord", out["coarse_coord"])
        loss = loss + cfg.lambda_coord * (torch.mean(out["coarse_coord"] ** 2)
                                          + torch.mean(fine_coord ** 2))
    return loss
