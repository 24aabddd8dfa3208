"""2-D image encoders for pixel-aligned NeRF conditioning (counterpart of
the JAX package's `models/encoder2d.py`).

  - SpatialEncoder: a ResNet-18-style backbone (BasicBlock stages) whose
    stage maps are resized to the stem's resolution (H/2, W/2) with
    `jax.image.resize`'s bilinear (ops/resize.py) and concatenated:
    d_latent = sum(stage_features);
  - bilinear_sample_2d: the pixel-aligned latent lookup (align_corners=True,
    border clamping; not `F.grid_sample`'s default);
  - ImageEncoder: the global pooled feature;
  - ConvEncoder: conv stages with GroupNorm and LeakyReLU, a global
    bottleneck broadcast over the coarsest skip, transposed convs up
    (flax "SAME" padding for both, `ConvTranspose2d`).

Tensors are channel-last (NHWC) at every module boundary, as in the JAX
package; convs view them as NCHW through a permute. BatchNorm is flax's
default (momentum 0.99, epsilon 1e-5) with an explicit `train` argument:
train=False normalises with the running statistics, which is how
FeatureNeRF always encodes. Submodule names are the flax tree's (`stem`,
`BatchNorm_0`, `stage{s}_block{b}`, `Conv_0`, ...), so convert.py maps a
flax tree onto them (`GroupNorm_{i}`, `conv_in`, `deconv_last`, ... for
ConvEncoder).
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



class GroupNorm(nn.Module):
    """flax nn.GroupNorm over the channel axis of NHWC (epsilon 1e-6):
    channels split into num_groups contiguous groups, mean and the fast
    variance max(0, E[x^2] - E[x]^2) over the spatial axes and the group,
    then y = (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, features: int, num_groups: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        xg = x.reshape(b, -1, g, c // g)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
        mean = mean.expand(b, 1, g, c // g).reshape(b, c)
        var = var.expand(b, 1, g, c // g).reshape(b, c)
        shape = (b,) + (1,) * (x.dim() - 2) + (c,)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias


def _transpose_pads(k: int, s: int) -> Tuple[int, int]:
    """lax.conv_transpose's "SAME" padding of the dilated input."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


class ConvTranspose2d(nn.Module):
    """flax nn.ConvTranspose with "SAME" padding over NHWC: n * stride
    outputs. weight (in, out, k, k) holds the flax kernel flipped
    (convert.py flips it), so that torch's conv_transpose2d, which pads
    the dilated input by k - 1 on each side, computes flax's product; the
    rows and columns that lax's narrower padding leaves out are cropped."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int,
                 use_bias: bool = True, kernel_init: InitSpec = LECUN_NORMAL):
        super().__init__()
        self.stride, self.kernel_init = stride, kernel_init
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(in_features, features, k, k))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator=None):
        i, o, k = self.weight.shape[:3]
        variance_scaling_(self.weight, self.kernel_init, i * k * k, o * k * k, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        k, s = self.weight.shape[-1], self.stride
        pad_a, pad_b = _transpose_pads(k, s)
        if max(pad_a, pad_b) > k - 1:
            raise ValueError(f"SAME padding of kernel {k}, stride {s} is not supported")
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias, stride=s)
        start = k - 1 - pad_a
        h, w = (n * s for n in x.shape[1:3])
        return y[:, :, start:start + h, start:start + w].permute(0, 2, 3, 1)


class ConvEncoder(nn.Module):
    """Convolutional encoder with a global bottleneck and a skip-concat up
    path (the reference's custom_encoder.py ConvEncoder):
    conv_in (k7/s2) -> n_down_layers stride-2 k3 stages doubling the
    channels (skips kept) -> conv_mid (k4/s4) -> the bottleneck map
    flattened into one vector, broadcast over the coarsest skip's grid ->
    transposed convs (k3/s2) over [broadcast | skip] -> deconv_last to
    last_channels. GroupNorm (min(32, C) groups) and LeakyReLU 0.01 after
    every conv but the last; convs without bias but deconv_last. NHWC in
    and out; built around 128 x 128 inputs (the flattened bottleneck is
    then 2 * 2 * mid_channels)."""

    def __init__(self, dim_in: int = 3, first_channels: int = 64, mid_channels: int = 128,
                 last_channels: int = 128, n_down_layers: int = 3,
                 use_skip_conn: bool = True, image_hw: Tuple[int, int] = (128, 128)):
        super().__init__()
        self.n_down_layers, self.use_skip_conn = n_down_layers, use_skip_conn
        norms = []

        def gn(c):
            norms.append(GroupNorm(c, min(32, c)))

        self.conv_in = Conv2d(dim_in, first_channels, 7, 2, "SAME", use_bias=False)
        gn(first_channels)
        ch = first_channels
        h, w = (-(-n // 2) for n in image_hw)
        for i in range(n_down_layers):
            setattr(self, f"conv{i}", Conv2d(ch, 2 * ch, 3, 2, "SAME", use_bias=False))
            gn(2 * ch)
            ch *= 2
            h, w = -(-h // 2), -(-w // 2)
        self.conv_mid = Conv2d(ch, mid_channels, 4, 4, "SAME", use_bias=False)
        gn(mid_channels)
        x_ch = -(-h // 4) * -(-w // 4) * mid_channels     # the flattened bottleneck
        for i in reversed(range(n_down_layers)):
            skip_ch = first_channels * 2 ** (i + 1)
            cin = x_ch + (skip_ch if use_skip_conn else 0)
            ch //= 2
            setattr(self, f"deconv{i}", ConvTranspose2d(cin, ch, 3, 2, use_bias=False))
            gn(ch)
            x_ch = ch
        self.deconv_last = ConvTranspose2d(x_ch, last_channels, 3, 2)
        for i, m in enumerate(norms):
            setattr(self, f"GroupNorm_{i}", m)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def act(v):
            return F.leaky_relu(v, 0.01)

        gi = iter(range(2 * self.n_down_layers + 2))

        def gn(v):
            return getattr(self, f"GroupNorm_{next(gi)}")(v)

        x = act(gn(self.conv_in(x)))
        inters = []
        for i in range(self.n_down_layers):
            x = act(gn(getattr(self, f"conv{i}")(x)))
            inters.append(x)
        x = act(gn(self.conv_mid(x)))
        b = x.shape[0]
        hw = inters[-1].shape[1:3]
        x = x.reshape(b, 1, 1, -1).expand(b, *hw, x[0].numel())
        for i in reversed(range(self.n_down_layers)):
            if self.use_skip_conn:
                x = torch.cat([x, inters[i]], dim=-1)
            x = act(gn(getattr(self, f"deconv{i}")(x)))
        return self.deconv_last(x)
