"""The representation zoo: `make_embedding(name)` (counterpart of the JAX
package's `models/representations.py`).

Names follow the reference's zoo: zero, state, simple, resnet18/34/50 and
imgnet / mocov2 / pri3d (ResNet-50), pixelnerf / featurenerf (the
pixelNeRF SpatialEncoder, pooled), dino (ViT-S/8 CLS), mvp (ViT-B/16 CLS),
pointnet, pointnet2, pointnerf / fusion (2-D + 3-D).

Where flax infers a layer's input width at `init`, the port builds the
module from an example observation: `Embedding.init(obs_example, seed,
device)` builds it, draws its weights as flax initialises them and returns
it; `Embedding(obs)` applies it (numpy or tensors in, a (B, out_dim) tensor
out). The JAX package folds crc32(name) into the init key, so that zoo
names draw distinct weights; the port seeds a `torch.Generator` from the
seed and the same crc32 (`name_seed`), so names still draw distinct
weights, but other draws than JAX's. Pretrained weights come through the
converters: `convert_torch_resnet_weights` / `convert_mocov2_weights`,
`convert_torch_pointnet2_weights`, `mvp_encoder_variables`,
`featurenerf_encoder_variables`, or convert.flax_to_state_dict of the JAX
package's variables; load them into the module `init` returns.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.models.blocks import Dense, init_weights
from real_robot_nerf_actor_tpu_torch.models.encoder2d import (
    Conv2d, SpatialEncoder, SpatialEncoderConfig)
from real_robot_nerf_actor_tpu_torch.models.pointnet2 import PointNet2Encoder
from real_robot_nerf_actor_tpu_torch.models.resnet import (
    RESNET18, RESNET34, RESNET50, TorchvisionResNet)
from real_robot_nerf_actor_tpu_torch.models.vit import (
    DinoViT, ViTConfig, convert_torch_mae_weights)
from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device

DINO_VIT_CFG = ViTConfig(patch_size=8, embed_dim=384, depth=12, num_heads=6)
MVP_VIT_CFG = ViTConfig(patch_size=16, embed_dim=768, depth=12, num_heads=12)


def name_seed(seed: int, name: str) -> int:
    """The generator seed of zoo entry `name`: the seed and crc32(name)."""
    return ((seed & 0xFFFFFFFF) << 32) | zlib.crc32(name.encode())


def to_tensors(obs, device) -> Any:
    """Arrays or tensors (or a dict of them) -> tensors on device."""
    if isinstance(obs, Mapping):
        return {k: torch.as_tensor(v, device=device) for k, v in obs.items()}
    return torch.as_tensor(obs, device=device)


def _batch_size(obs) -> int:
    return next(iter(obs.values())).shape[0] if isinstance(obs, Mapping) else obs.shape[0]


@dataclasses.dataclass
class Embedding:
    """A zoo entry. `build(obs_example)` makes its module (None for the
    parameter-free `zero` and `state`)."""
    name: str
    out_dim: int
    build: Optional[Callable[[Any], nn.Module]]
    module: Optional[nn.Module] = None
    device: torch.device = torch.device("cpu")

    def init(self, obs_example, seed: int = 0, device="cuda") -> Optional[nn.Module]:
        """Build the module for `obs_example` (batched), draw its weights
        from a generator seeded with name_seed(seed, name), put it on
        `device` and return it."""
        self.device = resolve_device(device)
        if self.build is not None:
            g = torch.Generator().manual_seed(name_seed(seed, self.name))
            self.module = init_weights(self.build(obs_example), g).to(self.device)
        return self.module

    def __call__(self, obs) -> torch.Tensor:
        obs = to_tensors(obs, self.device)
        if self.name == "zero":
            return torch.zeros((_batch_size(obs), self.out_dim), device=self.device)
        if self.name == "state":
            return obs.float()
        return self.module(obs)


class SimpleCNN(nn.Module):
    """Three 3x3 stride-2 convs at flax's "SAME" padding (32, 32, 64), relu,
    flattened in NHWC order, then a Dense."""

    def __init__(self, image_hw, in_channels: int = 3, out_dim: int = 64):
        super().__init__()
        h, w = image_hw
        cin = in_channels
        for i, f in enumerate((32, 32, 64)):
            setattr(self, f"Conv_{i}", Conv2d(cin, f, 3, 2, "SAME"))
            cin, h, w = f, -(-h // 2), -(-w // 2)
        self.Dense_0 = Dense(cin * h * w, out_dim)

    def forward(self, x):
        for i in range(3):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return self.Dense_0(x.reshape(x.shape[0], -1))


class PooledResNet(nn.Module):
    """The SpatialEncoder's latent averaged over the image (then a Dense to
    out_dim when out_dim > 0)."""

    def __init__(self, cfg: SpatialEncoderConfig, out_dim: int = 0):
        super().__init__()
        self.SpatialEncoder_0 = SpatialEncoder(cfg)
        if out_dim:
            self.Dense_0 = Dense(sum(cfg.stage_features), out_dim)

    def forward(self, x):
        f = self.SpatialEncoder_0(x).mean(dim=(1, 2))
        return self.Dense_0(f) if hasattr(self, "Dense_0") else f


class PointNet(nn.Module):
    """A PointNet set encoder over (B, N, C) clouds: Dense 64, 128, out_dim,
    each with a relu, then a max over the points."""

    def __init__(self, in_channels: int, out_dim: int = 128):
        super().__init__()
        cin = in_channels
        for i, f in enumerate((64, 128, out_dim)):
            setattr(self, f"Dense_{i}", Dense(cin, f))
            cin = f

    def forward(self, pts):
        x = pts
        for i in range(3):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return torch.amax(x, dim=-2)


class FusionNet(nn.Module):
    """2-D + 3-D fusion (the reference's pointnerf / bc_fusion path): a
    SimpleCNN over obs["image"] and a PointNet over obs["points"] with
    obs["colors"], each out_dim / 2 wide, concatenated."""

    def __init__(self, image_hw, point_channels: int, out_dim: int = 192):
        super().__init__()
        self.SimpleCNN_0 = SimpleCNN(image_hw, 3, out_dim // 2)
        self.PointNet_0 = PointNet(point_channels, out_dim // 2)

    def forward(self, obs):
        pc = torch.cat([obs["points"], obs["colors"]], dim=-1)
        return torch.cat([self.SimpleCNN_0(obs["image"]), self.PointNet_0(pc)], dim=-1)


class DinoCLS(nn.Module):
    """The CLS token of a DinoViT's final (post-norm) tokens."""

    def __init__(self, cfg: ViTConfig = DINO_VIT_CFG):
        super().__init__()
        self.vit = DinoViT(cfg)

    def forward(self, x):
        return self.vit(x)["tokens"][:, 0]


def make_embedding(name: str, out_dim: Optional[int] = None,
                   encoder_cfg: Optional[SpatialEncoderConfig] = None) -> Embedding:
    """Registry lookup by the reference's zoo name. `encoder_cfg` sets the
    pixelnerf / featurenerf backbone (it must match the FeatureNerfTrainer
    state the weights come from). Raises ValueError on an unknown name."""
    name = name.lower()

    def of(dim, build):
        return Embedding(name, dim, build)

    def image_hw(obs):
        return tuple(np.shape(obs)[1:3])

    if name == "zero":
        return of(out_dim or 1, None)
    if name == "state":    # identity: the state-BC baselines skip the encoder
        return of(out_dim or -1, None)
    if name == "simple":
        return of(out_dim or 64, lambda o: SimpleCNN(image_hw(o), np.shape(o)[-1], out_dim or 64))
    # torchvision-layout backbones; imgnet / mocov2 / pri3d are ResNet-50s
    # that load different checkpoints
    if name == "resnet18":
        return of(RESNET18.out_dim, lambda o: TorchvisionResNet(RESNET18))
    if name == "resnet34":
        return of(RESNET34.out_dim, lambda o: TorchvisionResNet(RESNET34))
    if name in ("resnet50", "imgnet", "mocov2", "pri3d"):
        return of(RESNET50.out_dim, lambda o: TorchvisionResNet(RESNET50))
    # pixelnerf: the SpatialEncoder backbone; featurenerf: the same encoder
    # from a FeatureNerfTrainer state (featurenerf_encoder_variables)
    if name in ("pixelnerf", "featurenerf"):
        cfg = encoder_cfg or SpatialEncoderConfig()
        return of(out_dim or sum(cfg.stage_features),
                  lambda o: PooledResNet(cfg, out_dim or 0))
    if name == "dino":
        return of(DINO_VIT_CFG.embed_dim, lambda o: DinoCLS(DINO_VIT_CFG))
    if name == "mvp":   # ViT-B/16 MAE backbone; checkpoints via mvp_encoder_variables
        return of(MVP_VIT_CFG.embed_dim, lambda o: DinoCLS(MVP_VIT_CFG))
    if name == "pointnet":
        return of(out_dim or 128, lambda o: PointNet(np.shape(o)[-1], out_dim or 128))
    if name == "pointnet2":
        return of(1024, lambda o: PointNet2Encoder(np.shape(o)[-1]))
    if name in ("pointnerf", "fusion"):
        return of(out_dim or 192, lambda o: FusionNet(
            image_hw(o["image"]), np.shape(o["points"])[-1] + np.shape(o["colors"])[-1],
            out_dim or 192))
    raise ValueError(f"unknown embedding {name!r}")


def mvp_encoder_variables(checkpoint: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """The 'mvp' entry's state_dict from an MAE/MVP torch checkpoint: the
    encoder converted by vit.convert_torch_mae_weights, under DinoCLS's
    `vit.` scope."""
    return {f"vit.{k}": v for k, v in convert_torch_mae_weights(checkpoint, MVP_VIT_CFG).items()}


def featurenerf_encoder_variables(state) -> Dict[str, torch.Tensor]:
    """The 'featurenerf' entry's state_dict from a FeatureNerfTrainer state
    (its module a PixelNerfNet): the SpatialEncoder's weights and BatchNorm
    statistics, under PooledResNet's `SpatialEncoder_0.` scope."""
    return {f"SpatialEncoder_0.{k}": v.detach().clone()
            for k, v in state.module.encoder.state_dict().items()}


def probe_out_dim(emb: Embedding, obs_example, seed: int = 0) -> int:
    """The width of the entry's feature on `obs_example`, from a forward on
    the CPU (the reference probes with a dummy forward too)."""
    probe = dataclasses.replace(emb, module=None)
    probe.init(obs_example, seed, device="cpu")
    with torch.no_grad():
        return int(probe(obs_example).shape[-1])
