"""The pixelNeRF field that FeatureNeRF distils into (the port's
`models/pixelnerf.py`, without the Aug-NeRF noise hooks, which the
configuration leaves off: a configuration that names them is refused as
an unknown key).

pixelNeRF (Yu et al., arXiv:2012.02190): each world query point goes into
every source view's camera frame, is projected to that view's pixels
(uv = -xy / z * focal + c, focal = (f, -f) for the OpenGL camera, then
normalised by (W, H) to [-1, 1]) and takes the encoder's latent there
(`bilinear_sample_2d`). The field's input is the positional code of the
camera-frame point and the view direction rotated into that camera; the
views are interleaved as rows and averaged at `combine_layer` inside
ResnetFC. FeatureNeRF (Ye et al., arXiv:2303.12786) widens the output by
the distilled embedding: rgb (sigmoid), sigma (relu), embed (d_embed) and,
with regress_coord, a coord residual against the views' mean camera-frame
point.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.frozen.models.encoder2d import (
    SpatialEncoder, SpatialEncoderConfig, bilinear_sample_2d)
from h100_bench.reference.frozen.models.resnetfc import ResnetFC
from h100_bench.reference.frozen.ops.rays import PositionalEncodingSpec, positional_encoding


@dataclasses.dataclass(frozen=True)
class PixelNerfConfig:
    d_embed: int = 384
    d_hidden: int = 512
    n_blocks: int = 5
    combine_layer: int = 3
    num_freqs: int = 6
    freq_factor: float = 1.5
    use_viewdirs: bool = True
    regress_coord: bool = False
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

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """images (NS, H, W, 3) in [-1, 1] -> latent (NS, H/2, W/2, C)."""
        return self.encoder(images)

    def forward(self, latent: torch.Tensor, poses_w2c: torch.Tensor, focal: torch.Tensor,
                c: torch.Tensor, image_shape: Tuple[int, int], xyz: torch.Tensor,
                viewdirs: torch.Tensor, swap_uv: bool = False) -> dict:
        """latent (NS, Hf, Wf, C); poses_w2c (NS, 4, 4); focal (2,) = (f, -f);
        c (2,); image_shape (H, W); xyz, viewdirs (B, 3). Returns rgb (B, 3),
        sigma (B,), embed (B, d_embed) [, coord_residual (B, 3)].
        swap_uv: a planted fault (u and v exchanged before the lookup)."""
        cfg = self.cfg
        ns, b = latent.shape[0], xyz.shape[0]
        h, w = image_shape
        rot = poses_w2c[:, :3, :3]
        xyz_cam = torch.einsum("nij,bj->nbi", rot, xyz) + poses_w2c[:, None, :3, 3]
        z = xyz_cam[..., 2:]
        uv = -xyz_cam[..., :2] / torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
        uv = uv * focal + c
        uv = uv / torch.tensor([w, h], dtype=uv.dtype, device=uv.device) * 2.0
        if swap_uv:
            uv = uv.flip(-1)
        lat = bilinear_sample_2d(latent, uv)                        # (NS, B, C)

        feat = positional_encoding(xyz_cam, self.code)
        if cfg.use_viewdirs:
            feat = torch.cat([feat, torch.einsum("nij,bj->nbi", rot, viewdirs)], dim=-1)
        lat = lat.transpose(0, 1).reshape(b * ns, -1)
        feat = feat.transpose(0, 1).reshape(b * ns, -1)
        out, _ = self.mlp((lat, feat), num_views=ns)
        out = out.reshape(b, cfg.d_out)
        res = {"rgb": torch.sigmoid(out[..., :3]), "sigma": F.relu(out[..., 3])}
        if cfg.regress_coord:
            res["embed"] = out[..., 4:-3]
            res["coord_residual"] = out[..., -3:] - xyz_cam.mean(dim=0)
        else:
            res["embed"] = out[..., 4:]
        return res
