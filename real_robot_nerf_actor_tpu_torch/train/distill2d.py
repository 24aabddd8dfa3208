"""2-D student distillation and offline teacher-feature extraction
(counterpart of the JAX package's `train/distill2d.py` and of
`scripts/dump_teacher_features.py`).

  - `Student2D` / `Student2DTrainer`: a small conv encoder trained to
    predict the teacher's dense feature map (MSE); where their resolutions
    differ the prediction is resized with `jax.image.resize`'s bilinear,
    antialiased when it shrinks (ops/resize.py);
  - `extract_teacher_features`: the DINO ViT's layer-9 keys and layer-11
    CLS attention of a batch of images, PCA-reduced on request;
  - `dump_teacher_features` / `main`: run the teacher over every view of
    every scene npz under a root and write `features` and `cls_attn` into
    each file, where FeatureNerfTrainer.scene_data reads them.

Without a checkpoint the teacher is a seed-drawn random DinoViT, as in the
JAX script (no pretrained DINO checkpoint is in the repository): the
features are this teacher's, not semantic DINO features. The weights come
from a `torch.Generator`, so the same seed gives another teacher than the
JAX package's `jax.random.key(seed)`. `--vit-ckpt` takes a DINO torch
checkpoint (a `torch.save` state_dict or an npz of its arrays, timm names)
through `convert_torch_dino_weights`. `extract_clip_features` dumps the
CLIP visual tower's prepool maps (models/clip_visual.py).

    python -m real_robot_nerf_actor_tpu_torch.train.distill2d --data-root DIR --pca 0
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import os
from typing import Dict, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.models.blocks import init_weights
from real_robot_nerf_actor_tpu_torch.models.encoder2d import Conv2d
from real_robot_nerf_actor_tpu_torch.models.vit import (
    DinoViT, ViTConfig, convert_torch_dino_weights, extract_dense_features)
from real_robot_nerf_actor_tpu_torch.ops.resize import resize
from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device
from real_robot_nerf_actor_tpu_torch.train.trainer import (
    Optimizer, TrainConfig, Trainer, TrainState)


class Student2D(nn.Module):
    """Small conv encoder predicting the teacher's dense feature map:
    two stride-2 3x3 convs, one 3x3, a 1x1 head; NHWC in and out."""

    def __init__(self, d_out: int = 384, width: int = 64):
        super().__init__()
        self.Conv_0 = Conv2d(3, width, 3, 2, 1)
        self.Conv_1 = Conv2d(width, width * 2, 3, 2, 1)
        self.Conv_2 = Conv2d(width * 2, width * 2, 3, 1, 1)
        self.Conv_3 = Conv2d(width * 2, d_out, 1)

    def forward(self, images):
        x = F.relu(self.Conv_0(images))
        x = F.relu(self.Conv_1(x))
        x = F.relu(self.Conv_2(x))
        return self.Conv_3(x)


@torch.no_grad()
def extract_teacher_features(vit: DinoViT, images: np.ndarray, feature_layer: int = 9,
                             attn_layer: int = 11, pca_components: Optional[int] = None):
    """images (N, H, W, 3) in [0, 1] -> (features (N, gh, gw, D), attn
    (N, heads, gh, gw)) as fp32 numpy, on the ViT's device. pca_components
    (when below the teacher's width) reduces the features with PCA fitted
    over all N * gh * gw vectors."""
    dev = next(vit.parameters()).device
    x = torch.as_tensor(np.asarray(images, np.float32), device=dev)
    feats, attn = extract_dense_features(vit, x, feature_layer, attn_layer)
    if pca_components is not None and pca_components < feats.shape[-1]:
        from real_robot_nerf_actor_tpu_torch.utils.pca import pca_fit_transform
        feats = pca_fit_transform(feats, pca_components)
    return feats.float().cpu().numpy(), attn.float().cpu().numpy()


@torch.no_grad()
def extract_clip_features(clip, images: np.ndarray) -> np.ndarray:
    """The reference's CLIP dumper: images (N, H, W, 3) in [0, 1],
    normalised with CLIP's mean and std, through a ClipVisualResNet (on its
    device; weights from clip_visual.convert_clip_visual_weights) -> its
    prepool maps (N, H/32, W/32, 2048) as fp32 numpy."""
    from real_robot_nerf_actor_tpu_torch.models.clip_visual import CLIP_MEAN, CLIP_STD
    mean = np.asarray(CLIP_MEAN, np.float32)
    std = np.asarray(CLIP_STD, np.float32)
    x = (np.asarray(images, np.float32) - mean) / std
    dev = next(clip.parameters()).device
    return clip(torch.as_tensor(x, device=dev)).float().cpu().numpy()


def load_teacher(cfg: ViTConfig, device, seed: int = 0,
                 vit_ckpt: Optional[str] = None) -> DinoViT:
    """The DinoViT of `cfg` on `device`: the DINO torch checkpoint at
    vit_ckpt (a torch.save state_dict, or an npz of its arrays), else
    weights drawn from torch.Generator().manual_seed(seed)."""
    vit = DinoViT(cfg)
    if vit_ckpt:
        if vit_ckpt.endswith(".npz"):
            with np.load(vit_ckpt) as z:
                sd = {k: z[k] for k in z.files}
        else:
            sd = torch.load(vit_ckpt, map_location="cpu", weights_only=True)
        vit.load_state_dict(convert_torch_dino_weights(sd, cfg))
    else:
        init_weights(vit, torch.Generator().manual_seed(seed))
    return vit.to(device).eval()


def dump_teacher_features(root: str, feature_layer: int = 9, attn_layer: int = 11,
                          pca: int = 64, patch: int = 8, embed_dim: int = 384,
                          depth: int = 12, seed: int = 0, vit_ckpt: Optional[str] = None,
                          device="cuda") -> Dict[str, object]:
    """Write the teacher's `features` (PCA-reduced to `pca` dims; 0 keeps
    the full width) and `cls_attn` into every scene npz under root. The
    teacher: a DinoViT(patch, embed_dim, depth, 6 heads, image_size
    max(H, W)) from load_teacher. Returns the shapes written and the
    teacher's provenance."""
    from real_robot_nerf_actor_tpu_torch.data.scene_dataset import load_scene, save_scene

    paths = sorted(glob.glob(os.path.join(root, "*.npz")))
    if not paths:
        raise FileNotFoundError(root)
    h, w = load_scene(paths[0]).images.shape[1:3]
    cfg = ViTConfig(patch_size=patch, embed_dim=embed_dim, depth=depth, image_size=max(h, w))
    vit = load_teacher(cfg, resolve_device(device), seed, vit_ckpt)
    prov = f"converted:{vit_ckpt}" if vit_ckpt else f"random-init seed={seed}"
    shapes = {}
    for p in paths:
        sc = load_scene(p)
        sc.features, sc.cls_attn = extract_teacher_features(
            vit, sc.images, feature_layer, attn_layer, pca_components=pca or None)
        save_scene(p, sc)
        shapes[os.path.basename(p)] = (sc.features.shape, sc.cls_attn.shape)
    return {"scenes": shapes, "teacher": prov}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Teacher-feature dumper for scene datasets (the counterpart of
    scripts/dump_teacher_features.py)."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--data-root", required=True, help="dir of scene .npz")
    ap.add_argument("--feature-layer", type=int, default=9)
    ap.add_argument("--attn-layer", type=int, default=11)
    ap.add_argument("--pca", type=int, default=64,
                    help="PCA-reduce teacher features to this dim; 0 = keep full width")
    ap.add_argument("--patch", type=int, default=8)
    ap.add_argument("--embed-dim", type=int, default=384)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vit-ckpt", default=None,
                    help="DINO torch checkpoint (torch.save state_dict or npz), optional")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    info = dump_teacher_features(args.data_root, args.feature_layer, args.attn_layer,
                                 args.pca, args.patch, args.embed_dim, args.depth,
                                 args.seed, args.vit_ckpt, args.device)
    for name, (f, a) in info["scenes"].items():
        print(f"{name}: features {f} attn {a}")
    print(f"teacher: ViT-{args.embed_dim}/p{args.patch} layer {args.feature_layer} "
          f"[{info['teacher']}]")
    return info


@dataclasses.dataclass(frozen=True)
class Distill2DConfig:
    d_feature: int = 384
    width: int = 64
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


class Student2DTrainer:
    def __init__(self, cfg: Distill2DConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        net = init_weights(Student2D(self.cfg.d_feature, self.cfg.width),
                           generator).to(self.device)
        return TrainState(step=0, module=net,
                          optimizer=Optimizer(self.cfg.train.optim, net.named_parameters()))

    def train_step(self, state: TrainState, batch: Mapping[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        """batch: images (B, H, W, 3) in [0, 1], features (B, hf, wf, D)."""
        net = state.module
        net.zero_grad(set_to_none=True)
        pred = net(batch["images"])
        tgt = batch["features"]
        if pred.shape[1:3] != tgt.shape[1:3]:
            pred = resize(pred, tgt.shape[1:3], "bilinear")
        loss = torch.mean((pred - tgt) ** 2)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    def make_trainer(self, data: Iterator) -> Trainer:
        return Trainer(self.cfg.train, self.train_step, data, self.init_state)


if __name__ == "__main__":
    main()
