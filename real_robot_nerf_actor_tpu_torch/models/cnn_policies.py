"""CNN policy networks, the reference's network_utils actor heads
(counterpart of the JAX package's `models/cnn_policies.py`): SiameseNet
(:479-518), CNNAndFcsNet (:520-577), CNNLangAndFcsNet with FiLM language
conditioning (:580-668, Conv2DFiLMBlock :112-127) and a 2-D soft-argmax.

NHWC at every module boundary, as in the JAX package. The stride-2 3x3
convs pad as flax's "SAME" does ((0, 1) on an even side, where torch's
padding=1 would give (1, 1)): `encoder2d.Conv2d(..., "SAME")`. The conv
maps are flattened in NHWC order before `fc0`, as flax flattens them, so
`fc0`'s kernel converts as any Dense kernel does. Submodule names are the
flax tree's (`conv{i}.Conv_0`, `film{i}.Dense_0`, `fc{i}`, `head`), so
`convert.flax_to_state_dict` maps a flax tree onto them.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from real_robot_nerf_actor_tpu_torch.models.blocks import Dense, act_fn, init_for
from real_robot_nerf_actor_tpu_torch.models.encoder2d import Conv2d


def _strided_hw(hw: Tuple[int, int], n: int) -> Tuple[int, int]:
    """Spatial size after n stride-2 "SAME" convs: ceil(side / 2) each."""
    h, w = hw
    for _ in range(n):
        h, w = -(-h // 2), -(-w // 2)
    return h, w


class Conv2DBlock(nn.Module):
    """flax "SAME" conv with a bias, then the activation."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, activation: Optional[str] = "relu"):
        super().__init__()
        self.activation = activation
        self.Conv_0 = Conv2d(in_features, features, kernel_size, stride, "SAME",
                             kernel_init=init_for(activation))

    def forward(self, x):
        return act_fn(self.activation)(self.Conv_0(x))


class FiLM(nn.Module):
    """Feature-wise linear modulation from a conditioning vector:
    x * (1 + gamma) + beta, (gamma, beta) = Dense(cond)."""

    def __init__(self, cond_features: int, features: int):
        super().__init__()
        self.Dense_0 = Dense(cond_features, 2 * features)

    def forward(self, x, cond):
        gamma, beta = self.Dense_0(cond).chunk(2, dim=-1)
        return x * (1.0 + gamma[:, None, None]) + beta[:, None, None]


class SiameseNet(nn.Module):
    """One conv trunk (stride-2 blocks) applied to each input stream; the
    flattened maps are concatenated."""

    def __init__(self, in_channels: int, filters: Sequence[int] = (32, 64),
                 activation: str = "relu"):
        super().__init__()
        self.n = len(filters)
        cin = in_channels
        for i, f in enumerate(filters):
            setattr(self, f"conv{i}", Conv2DBlock(cin, f, 3, 2, activation))
            cin = f

    def forward(self, streams: Sequence[torch.Tensor]) -> torch.Tensor:
        outs = []
        for x in streams:
            for i in range(self.n):
                x = getattr(self, f"conv{i}")(x)
            outs.append(x.reshape(x.shape[0], -1))
        return torch.cat(outs, dim=-1)


class CNNAndFcsNet(nn.Module):
    """Conv encoder, the low-dim input concatenated, an MLP head -> action
    logits or values. image_hw sizes `fc0` (flax infers it at init)."""

    def __init__(self, in_channels: int, image_hw: Tuple[int, int], low_dim: int,
                 filters: Sequence[int] = (32, 32, 64),
                 fc_layers: Sequence[int] = (256, 128), out_dim: int = 8,
                 activation: str = "relu", lang_dim: Optional[int] = None):
        super().__init__()
        self.activation = activation
        self.n_conv, self.n_fc = len(filters), len(fc_layers)
        cin = in_channels
        for i, f in enumerate(filters):
            setattr(self, f"conv{i}", Conv2DBlock(cin, f, 3, 2, activation))
            if lang_dim is not None:
                setattr(self, f"film{i}", FiLM(lang_dim, f))
            cin = f
        h, w = _strided_hw(image_hw, len(filters))
        din = h * w * cin + low_dim
        for i, f in enumerate(fc_layers):
            setattr(self, f"fc{i}", Dense(din, f))
            din = f
        self.head = Dense(din, out_dim)

    def _trunk(self, x, lang):
        for i in range(self.n_conv):
            x = getattr(self, f"conv{i}")(x)
            if lang is not None:
                x = getattr(self, f"film{i}")(x, lang)
        return x

    def forward(self, observations, low_dim_ins, lang_goal_emb=None):
        x = self._trunk(observations, lang_goal_emb)
        x = torch.cat([x.reshape(x.shape[0], -1), low_dim_ins], dim=-1)
        for i in range(self.n_fc):
            x = act_fn(self.activation)(getattr(self, f"fc{i}")(x))
        return self.head(x)


class CNNLangAndFcsNet(CNNAndFcsNet):
    """CNNAndFcsNet with FiLM language conditioning after each conv."""

    def __init__(self, in_channels: int, image_hw: Tuple[int, int], low_dim: int,
                 lang_dim: int, filters: Sequence[int] = (32, 32, 64),
                 fc_layers: Sequence[int] = (256, 128), out_dim: int = 8,
                 activation: str = "relu"):
        super().__init__(in_channels, image_hw, low_dim, filters, fc_layers, out_dim,
                         activation, lang_dim=lang_dim)

    def forward(self, observations, low_dim_ins, lang_goal_emb):
        return super().forward(observations, low_dim_ins, lang_goal_emb)


class SpatialSoftmax2D(nn.Module):
    """2-D soft-argmax keypoints: per channel the expected (x, y) in
    [-1, 1] under softmax(feat / temperature) over the map; (B, H, W, C) ->
    (B, 2C), interleaved (ex, ey) per channel."""

    def __init__(self, temperature: float = 0.01):
        super().__init__()
        self.temperature = temperature

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        b, h, w, c = feat.shape
        flat = feat.permute(0, 3, 1, 2).reshape(b * c, h * w)
        att = torch.softmax(flat / self.temperature, dim=-1)
        ys = torch.linspace(-1, 1, h, device=feat.device, dtype=att.dtype)
        xs = torch.linspace(-1, 1, w, device=feat.device, dtype=att.dtype)
        py, px = torch.meshgrid(ys, xs, indexing="ij")
        ex = att @ px.reshape(-1)
        ey = att @ py.reshape(-1)
        return torch.stack([ex, ey], dim=-1).reshape(b, c * 2)
