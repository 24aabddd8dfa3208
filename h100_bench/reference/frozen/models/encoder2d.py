"""The 2-D image encoder of pixelNeRF and its pixel-aligned lookup (the
port's `models/encoder2d.py`, cut to what FeatureNeRF runs).

  - SpatialEncoder: a ResNet-style backbone (a k7/s2 stem, BatchNorm, ReLU,
    a 3x3/s2 max pool, then BasicBlock stages, stride 2 at the first block
    of every stage after the first). Each stage's map, and the stem's, is
    resized to the stem's resolution (H/2, W/2) with the bilinear resize of
    `ops/resize.py` and the maps are concatenated: d_latent =
    sum(stage_features). pixelNeRF (Yu et al., arXiv:2012.02190) takes
    ResNet-34's first four stages (3, 4, 6 blocks); the configuration runs
    `blocks_per_stage` blocks a stage at the same widths, as the source
    repository's robo_dino_real encoder does.
  - bilinear_sample_2d: the latent at projected pixels, align_corners=True
    with border clamping (pixelNeRF's `F.grid_sample(...,
    align_corners=True, padding_mode="border")`).

Tensors are channel-last (NHWC) at the module boundary; the convs view them
as NCHW. BatchNorm normalises with its running statistics (inference mode),
as FeatureNeRF always encodes. Names are the port's (`stem`,
`BatchNorm_0`, `stage{s}_block{b}`, `Conv_0`, ...), so one state dict loads
into both.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.frozen.models.blocks import BatchNorm
from h100_bench.reference.frozen.ops.resize import resize_bilinear


class Conv2d(nn.Module):
    """A conv over NHWC with symmetric `padding`; weight (out, in, k, k)."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, stride=self.stride,
                     padding=self.padding)
        return y.permute(0, 2, 3, 1)


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv2d(in_features, features, 3, stride, 1, use_bias=False)
        self.BatchNorm_0 = BatchNorm(features, momentum=0.99)
        self.Conv_1 = Conv2d(features, features, 3, 1, 1, use_bias=False)
        self.BatchNorm_1 = BatchNorm(features, momentum=0.99)
        if in_features != features or stride != 1:
            # the projection shortcut: a 1x1 conv, no padding ("SAME" at k1)
            self.Conv_2 = Conv2d(in_features, features, 1, stride, 0, use_bias=False)
            self.BatchNorm_2 = BatchNorm(features, momentum=0.99)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if hasattr(self, "Conv_2"):
            x = self.BatchNorm_2(self.Conv_2(x))
        return F.relu(x + y)


@dataclasses.dataclass(frozen=True)
class SpatialEncoderConfig:
    stage_features: Tuple[int, ...] = (64, 64, 128, 256)
    blocks_per_stage: int = 2
    upsample_to_stage: int = 0


class SpatialEncoder(nn.Module):
    """images (B, H, W, 3) in [-1, 1] -> latent (B, H/2, W/2, d_latent)."""

    def __init__(self, cfg: SpatialEncoderConfig = SpatialEncoderConfig()):
        super().__init__()
        self.cfg = cfg
        f = cfg.stage_features
        self.stem = Conv2d(3, f[0], 7, 2, 3, use_bias=False)
        self.BatchNorm_0 = BatchNorm(f[0], momentum=0.99)
        cin = f[0]
        for si, feat in enumerate(f[1:], start=1):
            for bi in range(cfg.blocks_per_stage):
                stride = 2 if (bi == 0 and si > 1) else 1
                setattr(self, f"stage{si}_block{bi}", BasicBlock(cin, feat, stride))
                cin = feat

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = F.relu(self.BatchNorm_0(self.stem(images)))
        feats = [x]
        for si in range(1, len(c.stage_features)):
            if si == 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
            for bi in range(c.blocks_per_stage):
                x = getattr(self, f"stage{si}_block{bi}")(x)
            feats.append(x)
        target = feats[c.upsample_to_stage].shape[1:3]
        return torch.cat([resize_bilinear(f, target) for f in feats], dim=-1)


def bilinear_sample_2d(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W, C); uv (B, N, 2) in [-1, 1] (x right, y down) ->
    (B, N, C): `F.grid_sample` with align_corners=True and border padding,
    the port's arithmetic (the four taps blended along x, then along y)."""
    b, h, w, c = feat.shape
    x = ((uv[..., 0] + 1.0) * 0.5 * (w - 1)).clamp(0, w - 1)
    y = ((uv[..., 1] + 1.0) * 0.5 * (h - 1)).clamp(0, h - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    flat = feat.reshape(b, h * w, c)
    bi = torch.arange(b, device=feat.device)[:, None]

    def take(yi, xi):
        return flat[bi, yi * w + xi]

    v0 = take(y0, x0) * (1 - tx) + take(y0, x1) * tx
    v1 = take(y1, x0) * (1 - tx) + take(y1, x1) * tx
    return v0 * (1 - ty) + v1 * ty
