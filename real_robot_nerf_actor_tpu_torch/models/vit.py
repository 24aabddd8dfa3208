"""DINO Vision Transformer feature extractor (counterpart of the JAX
package's `models/vit.py`).

A ViT-S/8 (or B/16) whose layer-9 keys serve as dense features and whose
layer-11 CLS attention is an extra supervision signal. Inputs are
ImageNet-normalised. What the port keeps of flax's definitions, each held
by a test against the JAX module:
  - `nn.gelu` is the tanh approximation: F.gelu(approximate="tanh");
  - LayerNorm epsilon 1e-6 (torch's default is 1e-5);
  - the patch conv pads "SAME" (a side not divisible by the patch size
    gets one more, zero-padded patch);
  - the positional grid is resized with `jax.image.resize(method=
    "bicubic")`: Keys' cubic with a = -0.5, antialiased when it shrinks
    (ops/resize.py), not F.interpolate's a = -0.75.
Module names are the flax tree's (`patch_embed`, `cls_token`, `pos_embed`,
`block_{i}` with `norm1`, `attn.qkv`, `attn.proj`, `norm2`, `fc1`, `fc2`;
`norm`). `convert_torch_dino_weights` maps a public DINO (timm-layout)
torch checkpoint onto the port's names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.models.blocks import Dense
from real_robot_nerf_actor_tpu_torch.models.encoder2d import Conv2d
from real_robot_nerf_actor_tpu_torch.ops.resize import resize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 8
    embed_dim: int = 384           # ViT-S
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    image_size: int = 224          # native pos-emb grid


class _Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, dim * 3)
        self.proj = Dense(dim, dim)

    def forward(self, x, want_qkv: bool = False):
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                       # (B, H, N, d)
        attn = torch.softmax(torch.einsum("bhid,bhjd->bhij", q, k) * (c // h) ** -0.5, -1)
        out = torch.einsum("bhij,bhjd->bhid", attn, v).transpose(1, 2).reshape(b, n, c)
        extras = {"q": q, "k": k, "v": v, "attn": attn} if want_qkv else None
        return self.proj(out), extras


class _Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = Dense(dim, int(dim * mlp_ratio))
        self.fc2 = Dense(int(dim * mlp_ratio), dim)

    def forward(self, x, want_qkv: bool = False):
        y, extras = self.attn(self.norm1(x), want_qkv)
        x = x + y
        h = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))
        return x + h, extras


class DinoViT(nn.Module):
    def __init__(self, cfg: ViTConfig = ViTConfig()):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.embed_dim, cfg.patch_size
        native = cfg.image_size // p
        self.patch_embed = Conv2d(3, d, p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, native * native + 1, d))
        for i in range(cfg.depth):
            setattr(self, f"block_{i}", _Block(d, cfg.num_heads, cfg.mlp_ratio))
        self.norm = nn.LayerNorm(d, eps=1e-6)

    def reset_parameters(self, generator=None):
        """flax's initialisers of the two raw params: cls_token zeros,
        pos_embed N(0, 0.02^2)."""
        with torch.no_grad():
            self.cls_token.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, images: torch.Tensor, layers_to_return: Sequence[int] = (),
                normalize: bool = True) -> Dict:
        """images: (B, H, W, 3) in [0, 1]. Returns {'tokens': the final
        post-norm tokens (B, 1 + gh * gw, D), 'layers': {layer: {'tokens',
        'q', 'k', 'v', 'attn'}} for layers_to_return, 'grid': (gh, gw)}.
        Token 0 is CLS."""
        c = self.cfg
        if normalize:
            mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
            std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
            images = (images - mean) / std
        b = images.shape[0]
        x = self.patch_embed(images)
        gh, gw = x.shape[1], x.shape[2]
        x = torch.cat([self.cls_token.expand(b, 1, c.embed_dim),
                       x.reshape(b, gh * gw, c.embed_dim)], dim=1)
        native = c.image_size // c.patch_size
        pos_patch = self.pos_embed[:, 1:].reshape(1, native, native, c.embed_dim)
        if (gh, gw) != (native, native):
            pos_patch = resize(pos_patch, (gh, gw), "bicubic")
        x = x + torch.cat([self.pos_embed[:, :1],
                           pos_patch.reshape(1, gh * gw, c.embed_dim)], dim=1)
        want = set(layers_to_return)
        per_layer: Dict[int, Dict] = {}
        for i in range(c.depth):
            x, extras = getattr(self, f"block_{i}")(x, want_qkv=i in want)
            if i in want:
                per_layer[i] = {"tokens": x, **extras}
        return {"tokens": self.norm(x), "layers": per_layer, "grid": (gh, gw)}


def extract_dense_features(vit: DinoViT, images: torch.Tensor, feature_layer: int = 9,
                           attn_layer: int = 11):
    """Dense features = layer `feature_layer` keys (CLS dropped, heads
    flattened) as (B, gh, gw, D); cls attention = layer `attn_layer`'s
    attention from CLS to the patches, (B, heads, gh, gw)."""
    out = vit(images, layers_to_return=(feature_layer, attn_layer))
    gh, gw = out["grid"]
    k = out["layers"][feature_layer]["k"]
    b, h, n, d = k.shape
    feats = k.transpose(1, 2).reshape(b, n, h * d)[:, 1:].reshape(b, gh, gw, h * d)
    attn = out["layers"][attn_layer]["attn"][:, :, 0, 1:].reshape(b, -1, gh, gw)
    return feats, attn


def convert_torch_dino_weights(state_dict: Mapping[str, object], cfg: ViTConfig
                               ) -> Dict[str, torch.Tensor]:
    """A public DINO torch checkpoint (timm names: `patch_embed.proj.*`,
    `blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}.*`,
    `cls_token`, `pos_embed`, `norm.*`; values as tensors or arrays) -> the
    state_dict of the port's DinoViT of `cfg`. Both are in torch's layout,
    so the values carry over as they are."""
    sd = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in state_dict.items()}
    out = {"patch_embed.weight": sd["patch_embed.proj.weight"],
           "patch_embed.bias": sd["patch_embed.proj.bias"],
           "cls_token": sd["cls_token"], "pos_embed": sd["pos_embed"],
           "norm.weight": sd["norm.weight"], "norm.bias": sd["norm.bias"]}
    for i in range(cfg.depth):
        for src, dst in (("norm1", "norm1"), ("attn.qkv", "attn.qkv"),
                         ("attn.proj", "attn.proj"), ("norm2", "norm2"),
                         ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            for leaf in ("weight", "bias"):
                out[f"block_{i}.{dst}.{leaf}"] = sd[f"blocks.{i}.{src}.{leaf}"]
    return out


def convert_torch_mae_weights(checkpoint: Mapping[str, object], cfg: ViTConfig
                              ) -> Dict[str, torch.Tensor]:
    """An MAE/MVP torch checkpoint -> the port's DinoViT state_dict: the
    encoder keys share the DINO layout once the "model" / "state_dict"
    wrapper and a "module." prefix are taken off, the decoder keys
    (decoder_*, mask_token) dropped, and a fine-tuned "fc_norm" renamed to
    "norm"; then convert_torch_dino_weights."""
    sd = checkpoint
    for wrapper in ("model", "state_dict"):
        if wrapper in sd and isinstance(sd[wrapper], Mapping):
            sd = sd[wrapper]
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    sd = {k: v for k, v in sd.items() if not (k.startswith("decoder_") or k == "mask_token")}
    if "norm.weight" not in sd and "fc_norm.weight" in sd:
        sd["norm.weight"] = sd.pop("fc_norm.weight")
        sd["norm.bias"] = sd.pop("fc_norm.bias")
    return convert_torch_dino_weights(sd, cfg)
