"""Torchvision-layout ResNet family and its checkpoint converters
(counterpart of the JAX package's `models/resnet.py`).

A 7x7/s2 stem, a 3x3/s2 max pool, four stages of basic (18/34) or
bottleneck (50) blocks with 1x1-conv downsample shortcuts, and a global
average pool, as torchvision builds them: every pad is explicit (1 for the
3x3 convs, 3 for the stem), and the 1x1 shortcuts pad nothing. BatchNorm is
momentum 0.9, epsilon 1e-5 with an explicit `train` argument; the zoo
encoders run it on the running statistics. NHWC in; submodule names are the
flax tree's (`conv1`, `bn1`, `layer{s}_{i}` with `conv{c}`, `bn{c}`,
`down_conv`, `down_bn`), so convert.flax_to_state_dict maps JAX variables.

`convert_torch_resnet_weights` / `convert_mocov2_weights` map a torchvision
or MoCo v2 state_dict onto the port's names (both are in torch's layout, so
only the names change). Pretrained checkpoints are data the caller supplies.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.models.blocks import BatchNorm
from real_robot_nerf_actor_tpu_torch.models.encoder2d import Conv2d


@dataclasses.dataclass(frozen=True)
class ResNetSpec:
    bottleneck: bool
    stage_blocks: Tuple[int, int, int, int]

    @property
    def out_dim(self) -> int:
        return 512 * (4 if self.bottleneck else 1)


RESNET18 = ResNetSpec(False, (2, 2, 2, 2))
RESNET34 = ResNetSpec(False, (3, 4, 6, 3))
RESNET50 = ResNetSpec(True, (3, 4, 6, 3))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """flax's max_pool((3, 3), (2, 2), padding 1) over NHWC (pads with -inf)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


class _BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_features, features, 3, stride, 1, use_bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, 1, 1, use_bias=False)
        self.bn2 = BatchNorm(features)
        if in_features != features or stride != 1:
            self.down_conv = Conv2d(in_features, features, 1, stride, 0, use_bias=False)
            self.down_bn = BatchNorm(features)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if hasattr(self, "down_conv"):
            x = self.down_bn(self.down_conv(x), train)
        return F.relu(y + x)


class _Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        out = features * 4
        self.conv1 = Conv2d(in_features, features, 1, 1, 0, use_bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, stride, 1, use_bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = Conv2d(features, out, 1, 1, 0, use_bias=False)
        self.bn3 = BatchNorm(out)
        if in_features != out or stride != 1:
            self.down_conv = Conv2d(in_features, out, 1, stride, 0, use_bias=False)
            self.down_bn = BatchNorm(out)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        if hasattr(self, "down_conv"):
            x = self.down_bn(self.down_conv(x), train)
        return F.relu(y + x)


class TorchvisionResNet(nn.Module):
    """images (B, H, W, 3) -> the (B, out_dim) pooled feature, or the last
    stage's map (B, H/32, W/32, out_dim) with spatial=True."""

    def __init__(self, spec: ResNetSpec = RESNET18):
        super().__init__()
        self.spec = spec
        self.conv1 = Conv2d(3, 64, 7, 2, 3, use_bias=False)
        self.bn1 = BatchNorm(64)
        block = _Bottleneck if spec.bottleneck else _BasicBlock
        cin = 64
        for stage, n_blocks in enumerate(spec.stage_blocks):
            feats = 64 * 2 ** stage
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                setattr(self, f"layer{stage + 1}_{i}", block(cin, feats, stride))
                cin = feats * block.expansion

    def forward(self, x: torch.Tensor, train: bool = False, spatial: bool = False):
        y = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x), train)))
        for stage, n_blocks in enumerate(self.spec.stage_blocks):
            for i in range(n_blocks):
                y = getattr(self, f"layer{stage + 1}_{i}")(y, train)
        return y if spatial else y.mean(dim=(1, 2))


# --------------------------------------------------------------- converters
def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32))


def rename_resnet_blocks(state_dict: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """torchvision block names -> the port's: `layer{s}.{i}.` ->
    `layer{s}_{i}.`, `downsample.0` -> `down_conv`, `downsample.1` ->
    `down_bn`; `fc.*` and `num_batches_tracked` dropped."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        parts = k.split(".")
        if parts[0].startswith("layer") and len(parts) > 2 and parts[1].isdigit():
            parts = [f"{parts[0]}_{parts[1]}"] + parts[2:]
        k = ".".join(parts).replace("downsample.0", "down_conv").replace(
            "downsample.1", "down_bn")
        out[k] = _tensor(v)
    return out


def convert_torch_resnet_weights(state_dict: Mapping[str, object], spec: ResNetSpec
                                 ) -> Dict[str, torch.Tensor]:
    """A torchvision-layout ResNet state_dict (values as tensors or arrays;
    `fc.*` ignored) -> the state_dict of the port's TorchvisionResNet(spec).
    Raises KeyError when a weight of `spec` is missing."""
    sd = rename_resnet_blocks(state_dict)
    return {k: sd[k] for k in TorchvisionResNet(spec).state_dict()}


def convert_mocov2_weights(state_dict: Mapping[str, object], spec: ResNetSpec = RESNET50
                           ) -> Dict[str, torch.Tensor]:
    """A MoCo v2 checkpoint's state_dict (`module.encoder_q.` or
    `encoder_q.` prefixes; the MLP head and the key encoder dropped) -> the
    port's TorchvisionResNet(spec)."""
    stripped = {}
    for k, v in state_dict.items():
        for prefix in ("module.encoder_q.", "encoder_q."):
            if k.startswith(prefix):
                stripped[k[len(prefix):]] = v
                break
    return convert_torch_resnet_weights(stripped, spec)
