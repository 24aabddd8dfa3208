"""2-D image encoders for pixel-aligned NeRF conditioning (counterpart of
the JAX package's `models/encoder2d.py`).

  - SpatialEncoder: a ResNet-18-style backbone (BasicBlock stages) whose
    stage maps are resized to the stem's resolution (H/2, W/2) with
    `jax.image.resize`'s bilinear (ops/resize.py) and concatenated:
    d_latent = sum(stage_features);
  - bilinear_sample_2d: the pixel-aligned latent lookup (align_corners=True,
    border clamping; not `F.grid_sample`'s default);
  - ImageEncoder: the global pooled feature.

Tensors are channel-last (NHWC) at every module boundary, as in the JAX
package; convs view them as NCHW through a permute. BatchNorm is flax's
default (momentum 0.99, epsilon 1e-5) with an explicit `train` argument:
train=False normalises with the running statistics, which is how
FeatureNeRF always encodes. Submodule names are the flax tree's (`stem`,
`BatchNorm_0`, `stage{s}_block{b}`, `Conv_0`, ...), so convert.py maps a
flax tree onto them. `ConvEncoder` is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.models.blocks import (
    LECUN_NORMAL, BatchNorm, Dense, InitSpec, variance_scaling_)
from real_robot_nerf_actor_tpu_torch.ops.resize import resize


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one axis: ceil(n / s) outputs."""
    pad = max((-(-n // s) - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2


class Conv2d(nn.Module):
    """flax nn.Conv over NHWC; weight (out, in, k, k) in torch's layout.
    padding: an int (each side), or "SAME" as flax pads by default."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: Union[int, str] = "SAME",
                 use_bias: bool = True, kernel_init: InitSpec = LECUN_NORMAL):
        super().__init__()
        self.stride, self.padding, self.kernel_init = stride, padding, kernel_init
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator=None):
        o, i, k = self.weight.shape[:3]
        variance_scaling_(self.weight, self.kernel_init, i * k * k, o * k * k, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        k, s = self.weight.shape[-1], self.stride
        if self.padding == "SAME":
            (t, b), (l, r) = (_same_pads(n, k, s) for n in x.shape[2:])
            if t == b and l == r:
                pad = (t, l)
            else:
                x, pad = F.pad(x, (l, r, t, b)), 0
        else:
            pad = self.padding
        return F.conv2d(x, self.weight, self.bias, stride=s, padding=pad).permute(0, 2, 3, 1)


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv2d(in_features, features, 3, stride, 1, use_bias=False)
        self.BatchNorm_0 = BatchNorm(features, momentum=0.99)
        self.Conv_1 = Conv2d(features, features, 3, 1, 1, use_bias=False)
        self.BatchNorm_1 = BatchNorm(features, momentum=0.99)
        if in_features != features or stride != 1:
            self.Conv_2 = Conv2d(in_features, features, 1, stride, use_bias=False)
            self.BatchNorm_2 = BatchNorm(features, momentum=0.99)

    def forward(self, x, train: bool = False):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        if hasattr(self, "Conv_2"):
            x = self.BatchNorm_2(self.Conv_2(x), train)
        return F.relu(x + y)


@dataclasses.dataclass(frozen=True)
class SpatialEncoderConfig:
    stage_features: Tuple[int, ...] = (64, 64, 128, 256)
    blocks_per_stage: int = 2      # ResNet18-style
    upsample_to_stage: int = 0     # concat all stages at stage-0 resolution


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

    @property
    def d_latent(self) -> int:
        return sum(self.cfg.stage_features)

    def forward(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        c = self.cfg
        x = F.relu(self.BatchNorm_0(self.stem(images), train))
        feats = [x]
        for si in range(1, len(c.stage_features)):
            if si == 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
            for bi in range(c.blocks_per_stage):
                x = getattr(self, f"stage{si}_block{bi}")(x, train)
            feats.append(x)
        target = feats[c.upsample_to_stage].shape[1:3]
        return torch.cat([resize(f, target, "bilinear") for f in feats], dim=-1)


def bilinear_sample_2d(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixel-aligned latent lookup. feat: (B, H, W, C); uv: (B, N, 2) in
    [-1, 1] (x right, y down; align_corners=True, border clamping).
    Returns (B, N, C). Its backward is an accumulating index_put_."""
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


class ImageEncoder(nn.Module):
    """Global image feature: the SpatialEncoder's latent averaged over the
    image, then a Dense."""

    def __init__(self, latent_size: int = 128,
                 cfg: SpatialEncoderConfig = SpatialEncoderConfig()):
        super().__init__()
        self.backbone = SpatialEncoder(cfg)
        self.Dense_0 = Dense(sum(cfg.stage_features), latent_size)

    def forward(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.Dense_0(self.backbone(images, train).mean(dim=(1, 2)))

