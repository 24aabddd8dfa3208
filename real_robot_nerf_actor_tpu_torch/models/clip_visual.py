"""CLIP's visual tower, the ModifiedResNet RN50 (counterpart of the JAX
package's `models/clip_visual.py`).

A three-conv stem (3x3 convs, the first at stride 2) and a 2x2 average
pool; anti-aliased bottlenecks, where a strided block average-pools before
its stride-1 1x1 conv and on its shortcut; an attention pool whose query is
the mean token, the positional embedding added to every token. forward(x)
returns the prepool map (B, H/32, W/32, 2048), which is what the reference's
dumper saves; pool=True returns the attention-pooled (B, output_dim)
embedding. NHWC, BatchNorm on its running statistics (momentum 0.9, epsilon
1e-5). Names are the flax tree's (`conv{1,2,3}`, `bn{1,2,3}`,
`layer{s}_{i}`, `down_conv`, `down_bn`, `attnpool` with
`positional_embedding`, `q_proj`, `k_proj`, `v_proj`, `c_proj`).
`convert_clip_visual_weights` maps the `visual.*` half of an OpenAI CLIP
RN50 state_dict.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.models.blocks import BatchNorm, Dense
from real_robot_nerf_actor_tpu_torch.models.encoder2d import Conv2d
from real_robot_nerf_actor_tpu_torch.models.resnet import rename_resnet_blocks

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ClipVisualConfig:
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)   # RN50
    width: int = 64
    output_dim: int = 1024
    heads: int = 32
    input_resolution: int = 224

    @property
    def feat_dim(self) -> int:
        return self.width * 32        # 2048 for RN50


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


class _ClipBottleneck(nn.Module):
    def __init__(self, in_features: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        out = planes * 4
        self.conv1 = Conv2d(in_features, planes, 1, 1, 0, use_bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, use_bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, out, 1, 1, 0, use_bias=False)
        self.bn3 = BatchNorm(out)
        if stride > 1 or in_features != out:
            self.down_conv = Conv2d(in_features, out, 1, 1, 0, use_bias=False)
            self.down_bn = BatchNorm(out)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.stride > 1:
            y = _avg_pool(y, self.stride)
        y = self.bn3(self.conv3(y))
        if hasattr(self, "down_conv"):
            r = _avg_pool(x, self.stride) if self.stride > 1 else x
            x = self.down_bn(self.down_conv(r))
        return F.relu(y + x)


class ClipAttentionPool(nn.Module):
    """feats (B, h, w, C) -> (B, output_dim): one query, the mean token,
    attending over the mean token and the h * w tokens, each with its
    positional embedding ((h * w + 1, C), drawn N(0, 1 / C))."""

    def __init__(self, width: int, heads: int, output_dim: int, n_tokens: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.zeros(n_tokens + 1, width))
        self.q_proj = Dense(width, width)
        self.k_proj = Dense(width, width)
        self.v_proj = Dense(width, width)
        self.c_proj = Dense(width, output_dim)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            c = self.positional_embedding.shape[1]
            self.positional_embedding.normal_(0.0, c ** -0.5, generator=generator)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        b, h, w, c = feats.shape
        toks = feats.reshape(b, h * w, c)
        toks = torch.cat([toks.mean(dim=1, keepdim=True), toks], dim=1)
        toks = toks + self.positional_embedding[None]
        hd = c // self.heads
        q = self.q_proj(toks[:, :1]).reshape(b, 1, self.heads, hd).transpose(1, 2)
        k = self.k_proj(toks).reshape(b, -1, self.heads, hd).transpose(1, 2)
        v = self.v_proj(toks).reshape(b, -1, self.heads, hd).transpose(1, 2)
        attn = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) / hd ** 0.5, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v).transpose(1, 2).reshape(b, c)
        return self.c_proj(out)


class ClipVisualResNet(nn.Module):
    """x (B, H, W, 3) CLIP-normalised images. forward(x) is the prepool
    map (B, H/32, W/32, feat_dim); pool=True the (B, output_dim) embedding
    (the attention pool's positional grid is input_resolution / 32)."""

    def __init__(self, cfg: ClipVisualConfig = ClipVisualConfig()):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        cin = 3
        for i, ch in enumerate((w // 2, w // 2, w)):
            setattr(self, f"conv{i + 1}", Conv2d(cin, ch, 3, 2 if i == 0 else 1, 1,
                                                 use_bias=False))
            setattr(self, f"bn{i + 1}", BatchNorm(ch))
            cin = ch
        for stage, n_blocks in enumerate(cfg.layers):
            planes = w * 2 ** stage
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                setattr(self, f"layer{stage + 1}_{i}", _ClipBottleneck(cin, planes, stride))
                cin = planes * 4
        grid = cfg.input_resolution // 32
        self.attnpool = ClipAttentionPool(cfg.feat_dim, cfg.heads, cfg.output_dim, grid * grid)

    def forward(self, x: torch.Tensor, pool: bool = False) -> torch.Tensor:
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = _avg_pool(x, 2)
        for stage, n_blocks in enumerate(self.cfg.layers):
            for i in range(n_blocks):
                x = getattr(self, f"layer{stage + 1}_{i}")(x)
        return self.attnpool(x) if pool else x


def convert_clip_visual_weights(state_dict: Mapping[str, object],
                                cfg: ClipVisualConfig = ClipVisualConfig()
                                ) -> Dict[str, torch.Tensor]:
    """The `visual.*` entries of an OpenAI CLIP state_dict (or a visual
    state_dict already stripped of the prefix) -> the port's
    ClipVisualResNet(cfg) state_dict. Both are in torch's layout; only the
    block names change. Without `attnpool.*` the pool keeps its own weights
    (load with strict=False), as the prepool map needs none of them."""
    sd = {(k[len("visual."):] if k.startswith("visual.") else k): v
          for k, v in state_dict.items()}
    sd = rename_resnet_blocks(sd)
    want = ClipVisualResNet(cfg).state_dict()
    return {k: sd[k] for k in want if k in sd or not k.startswith("attnpool.")}
