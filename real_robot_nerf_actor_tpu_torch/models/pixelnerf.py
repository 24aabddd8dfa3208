"""Image-conditioned pixelNeRF field, the FeatureNeRF pretraining model
(counterpart of the JAX package's `models/pixelnerf.py`).

World query points go into each source view's camera frame, are projected
to pixels (uv = -xy / z * focal + c, normalised by (w, h) to [-1, 1]), and
the encoder's latent is sampled there (bilinear_sample_2d). With the
positional code of the camera-frame point (and the view direction rotated
into that camera), the views are interleaved as (B * NS, D) rows and pushed
through ResnetFC, which averages the views at combine_layer. Heads: rgb
(sigmoid), sigma (relu), embed [, coord residual against the view-averaged
camera-frame point].

Spans (`utils/profiling.named_scope`), one each a field call:
featurenerf.project (the points into the source views, uv, the latent
lookup) and featurenerf.field (the positional code, ResnetFC and the
heads).

Aug-NeRF hooks (use_input_aug / use_output_aug, train=True only): gaussian
noise on the query points and on the raw output, scaled by
aug_noise_scale. The noise comes from the `aug_noise` argument ({"input":
(B, 3), "output": (B, d_out)} standard normals) or else from `generator`.
Module names are the flax tree's (`encoder`, `mlp`).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.models.encoder2d import (
    SpatialEncoder, SpatialEncoderConfig, bilinear_sample_2d)
from real_robot_nerf_actor_tpu_torch.models.resnetfc import ResnetFC
from real_robot_nerf_actor_tpu_torch.ops.rays import (
    PositionalEncodingSpec, positional_encoding)
from real_robot_nerf_actor_tpu_torch.ops.sampling import normal
from real_robot_nerf_actor_tpu_torch.utils.profiling import named_scope


@dataclasses.dataclass(frozen=True)
class PixelNerfConfig:
    d_embed: int = 384            # DINO ViT-S feature dim
    d_hidden: int = 512
    n_blocks: int = 5
    combine_layer: int = 3
    num_freqs: int = 6
    freq_factor: float = 1.5
    use_viewdirs: bool = True
    regress_coord: bool = False
    use_input_aug: bool = False
    use_output_aug: bool = False
    aug_noise_scale: float = 0.0
    encoder: SpatialEncoderConfig = SpatialEncoderConfig()

    @property
    def d_latent(self) -> int:
        return sum(self.encoder.stage_features)

    @property
    def d_out(self) -> int:
        return 4 + self.d_embed + (3 if self.regress_coord else 0)


class PixelNerfNet(nn.Module):
    def __init__(self, cfg: PixelNerfConfig = PixelNerfConfig()):
        super().__init__()
        self.cfg = cfg
        self.code = PositionalEncodingSpec(cfg.num_freqs, 3, cfg.freq_factor, True)
        d_in = self.code.d_out + (3 if cfg.use_viewdirs else 0)
        self.encoder = SpatialEncoder(cfg.encoder)
        self.mlp = ResnetFC(d_in=d_in, d_out=cfg.d_out, n_blocks=cfg.n_blocks,
                            d_latent=cfg.d_latent, d_hidden=cfg.d_hidden,
                            combine_layer=cfg.combine_layer)

    def encode(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        """images: (NS, H, W, 3) in [-1, 1] -> latent (NS, H/2, W/2, C)."""
        return self.encoder(images, train=train)

    def encode_and_query(self, images, poses_w2c, focal, c, xyz, viewdirs,
                         train: bool = False, **kw):
        """Encode the source views, then query the field."""
        latent = self.encode(images, train=train)
        return self(latent, poses_w2c, focal, c, tuple(images.shape[1:3]), xyz, viewdirs,
                    train=train, **kw)

    def _aug(self, name, shape, like, aug_noise, generator):
        if aug_noise is not None and aug_noise.get(name) is not None:
            return aug_noise[name].to(like)
        return normal(shape, like, generator)

    def forward(self, latent: torch.Tensor, poses_w2c: torch.Tensor, focal: torch.Tensor,
                c: torch.Tensor, image_shape: Tuple[int, int], xyz: torch.Tensor,
                viewdirs: Optional[torch.Tensor] = None, train: bool = False,
                aug_noise: Optional[Mapping[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """latent: (NS, Hf, Wf, C) encoded source views of one object.
        poses_w2c: (NS, 4, 4) world -> camera. focal: (2,) [fx, fy] (fy's
        sign flipped, the reference's convention). c: (2,) principal point.
        image_shape: (H, W) of the source images. xyz, viewdirs: (B, 3).
        Returns rgb (B, 3), sigma (B,), embed (B, d_embed)
        [, coord_residual (B, 3)]."""
        cfg = self.cfg
        ns, b = latent.shape[0], xyz.shape[0]
        h, w = image_shape
        aug = train and cfg.aug_noise_scale > 0
        if cfg.use_input_aug and aug:
            xyz = xyz + self._aug("input", xyz.shape, xyz, aug_noise,
                                  generator) * cfg.aug_noise_scale

        rot = poses_w2c[:, :3, :3]
        with named_scope("featurenerf.project"):
            xyz_cam = torch.einsum("nij,bj->nbi", rot, xyz) + poses_w2c[:, None, :3, 3]
            z = xyz_cam[..., 2:]
            uv = -xyz_cam[..., :2] / torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
            uv = uv * focal + c
            uv = uv / torch.tensor([w, h], dtype=uv.dtype, device=uv.device) * 2.0
            lat = bilinear_sample_2d(latent, uv)                        # (NS, B, C)

        with named_scope("featurenerf.field"):
            feat = positional_encoding(xyz_cam, self.code)
            if cfg.use_viewdirs:
                if viewdirs is None:
                    raise ValueError("use_viewdirs needs viewdirs")
                feat = torch.cat([feat, torch.einsum("nij,bj->nbi", rot, viewdirs)], dim=-1)

            # interleave views: (NS, B, D) -> (B * NS, D), so combine reduces views
            lat = lat.transpose(0, 1).reshape(b * ns, -1)
            feat = feat.transpose(0, 1).reshape(b * ns, -1)
            out, _ = self.mlp((lat, feat), num_views=ns)
            out = out.reshape(b, cfg.d_out)
            if cfg.use_output_aug and aug:
                out = out + self._aug("output", out.shape, out, aug_noise,
                                      generator) * cfg.aug_noise_scale

            res = {"rgb": torch.sigmoid(out[..., :3]), "sigma": F.relu(out[..., 3])}
            if cfg.regress_coord:
                res["embed"] = out[..., 4:-3]
                res["coord_residual"] = out[..., -3:] - xyz_cam.mean(dim=0)
            else:
                res["embed"] = out[..., 4:]
        return res
