"""Geometry-guided contrastive teacher for FeatureNeRF distillation
(counterpart of the JAX package's `train/teacher.py` and of
`scripts/train_teacher.py`).

A 2-D encoder trained so that pixels which observe the same 3-D point (known
from the scenes' depth and poses) embed near each other and pixels of other
points do not: InfoNCE over depth-reprojection-matched pixel pairs of two
views of one scene a step (Pri3D's geometry-guided pretraining). Its dense
features and a feature-energy saliency map are written into the scene npz
files where FeatureNerfTrainer.scene_data reads `features` and `cls_attn`.

  - `TeacherConfig`, `ContrastiveTeacher` (the port's `SpatialEncoder` on
    images * 2 - 1, then a `proj` Dense: (B, H/2, W/2, d_embed));
  - `match_pixels`: the ground-truth correspondences (numpy; the same
    arrays and the same draws from the Generator as the JAX package's);
  - `TeacherTrainer`: the symmetric InfoNCE step (BatchNorm on batch
    statistics, running statistics updated; optax's adam through
    `train.trainer.adam`), `feature_maps`;
  - `fit`: the CLI's training loop (scene and view draws, match_pixels);
  - `teacher_quality`: matched vs random cosine and nearest-neighbour
    correspondence within 2 px, on held-out scenes;
  - `load_teacher_state`: a `--out` file of this module, or the JAX
    package's msgpack state (convert.read_flax_msgpack), params, batch
    statistics and adam state;
  - `main`: the CLI.

Reprojection conventions: z-depth, principal point at ((w-1)/2, (h-1)/2).
The weights of a fresh teacher come from a `torch.Generator`, so a seed
gives other weights than the JAX package's `jax.random.key(seed)`.

    python -m real_robot_nerf_actor_tpu_torch.train.teacher --data-root DIR \\
        --steps 3000 --out teacher.pt --dump --quality-out quality.json
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.models.blocks import Dense, init_weights
from real_robot_nerf_actor_tpu_torch.models.encoder2d import (
    SpatialEncoder, SpatialEncoderConfig, bilinear_sample_2d)
from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device
from real_robot_nerf_actor_tpu_torch.train.trainer import TrainState, adam


@dataclasses.dataclass(frozen=True)
class TeacherConfig:
    d_embed: int = 64
    temperature: float = 0.1
    n_pairs: int = 256          # matched pixel pairs a step
    lr: float = 1e-3
    steps: int = 3000
    seed: int = 0
    depth_tol: float = 0.02     # relative occlusion-check tolerance
    encoder: SpatialEncoderConfig = dataclasses.field(default_factory=SpatialEncoderConfig)


class ContrastiveTeacher(nn.Module):
    """SpatialEncoder + a linear projection: images (B, H, W, 3) in [0, 1]
    -> (B, H/2, W/2, d_embed). Submodule names are the flax tree's."""

    def __init__(self, cfg: TeacherConfig = TeacherConfig()):
        super().__init__()
        self.cfg = cfg
        self.SpatialEncoder_0 = SpatialEncoder(cfg.encoder)
        self.proj = Dense(self.SpatialEncoder_0.d_latent, cfg.d_embed)

    def forward(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.proj(self.SpatialEncoder_0(images * 2.0 - 1.0, train=train))


def match_pixels(poses: np.ndarray, focal: float, depth: np.ndarray, i: int, j: int,
                 n: int, rng: np.random.Generator, depth_tol: float = 0.02
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Ground-truth pixel correspondences view i -> view j: unproject
    up to 4n pixels of view i with finite depth, reproject into view j,
    keep those in view whose depth there agrees within depth_tol. Returns
    (uv_i (n, 2) float32 [x, y], uv_j (n, 2)), padded by repetition to n,
    or None if fewer than n // 2 match (or view i has under 8 pixels)."""
    h, w = depth.shape[1:3]
    cx, cy, f = (w - 1) / 2.0, (h - 1) / 2.0, float(focal)
    d_a, d_b = depth[i], depth[j]
    ys, xs = np.nonzero(np.isfinite(d_a))
    if len(ys) < 8:
        return None
    take = rng.choice(len(ys), size=min(4 * n, len(ys)), replace=False)
    ys, xs = ys[take], xs[take]
    dirs = np.stack([(xs - cx) / f, -(ys - cy) / f, -np.ones_like(xs, np.float64)], -1)
    t = d_a[ys, xs] / (-dirs[:, 2])
    pts = (dirs * t[:, None]) @ poses[i][:3, :3].T + poses[i][:3, 3]
    pc = (pts - poses[j][:3, 3]) @ poses[j][:3, :3]
    zb = -pc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        xb = pc[:, 0] / zb * f + cx
        yb = -pc[:, 1] / zb * f + cy
    xi, yi = np.round(xb).astype(int), np.round(yb).astype(int)
    inb = (zb > 0) & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    vis = inb.copy()
    seen = d_b[yi[inb], xi[inb]]
    vis[inb] &= np.isfinite(seen)
    vis[inb] &= np.abs(np.where(np.isfinite(seen), seen, 1e9) - zb[inb]) < depth_tol * zb[inb]
    if vis.sum() < n // 2:
        return None
    keep = np.nonzero(vis)[0][:n]
    uv_i = np.stack([xs[keep], ys[keep]], -1).astype(np.float32)
    uv_j = np.stack([xb[keep], yb[keep]], -1).astype(np.float32)
    if len(keep) < n:
        pad = rng.integers(0, len(keep), n - len(keep))
        uv_i = np.concatenate([uv_i, uv_i[pad]])
        uv_j = np.concatenate([uv_j, uv_j[pad]])
    return uv_i, uv_j


class TeacherTrainer:
    """InfoNCE over matched pixels, two views of one scene a step. Runs on
    CUDA unless device="cpu"."""

    def __init__(self, cfg: TeacherConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """A fresh teacher (weights drawn as flax initialises them, from
        `generator`) and its adam optimizer."""
        net = init_weights(ContrastiveTeacher(self.cfg), generator).to(self.device)
        return TrainState(step=0, module=net, optimizer=adam(self.cfg.lr,
                                                             net.named_parameters()))

    def loss(self, net: ContrastiveTeacher, imgs: torch.Tensor, uv_a: torch.Tensor,
             uv_b: torch.Tensor, train: bool = True):
        """(loss, metrics) of one pair of views imgs (2, H, W, 3) and their
        matched pixels uv_a, uv_b (P, 2) [x, y] at image resolution. With
        train, BatchNorm normalises with the pair's statistics and updates
        its running ones."""
        c = self.cfg
        feat = net(imgs, train=train)
        fh, fw = feat.shape[1], feat.shape[2]

        def norm_uv(uv):    # image pixels -> [-1, 1] of the half-resolution map
            xf, yf = uv[:, 0] / 2.0, uv[:, 1] / 2.0
            return torch.stack([2.0 * xf / (fw - 1) - 1.0, 2.0 * yf / (fh - 1) - 1.0], -1)

        za = bilinear_sample_2d(feat[0:1], norm_uv(uv_a)[None])[0]
        zb = bilinear_sample_2d(feat[1:2], norm_uv(uv_b)[None])[0]
        za = za / (torch.linalg.vector_norm(za, dim=-1, keepdim=True) + 1e-6)
        zb = zb / (torch.linalg.vector_norm(zb, dim=-1, keepdim=True) + 1e-6)
        logits = za @ zb.T / c.temperature
        labels = torch.arange(logits.shape[0], device=logits.device)
        loss = (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) * 0.5
        with torch.no_grad():
            pos = (za * zb).sum(-1).mean()
            acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"loss": loss.detach(), "pos_sim": pos, "pair_acc": acc}

    def train_step(self, state: TrainState, imgs: torch.Tensor, uv_a: torch.Tensor,
                   uv_b: torch.Tensor):
        """One adam step on the pair; updates `state` in place and returns
        (state, metrics)."""
        net = state.module
        for p in net.parameters():
            p.grad = None
        loss, metrics = self.loss(net, imgs, uv_a, uv_b, train=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def feature_maps(self, state: TrainState, images: np.ndarray, batch: int = 8
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(N, H, W, 3) in [0, 1] -> (features (N, H/2, W/2, D) float32,
        attn (N, H/2, W/2) float32 in [0, 1]: the feature energy between
        its 5th and 95th percentile, the stand-in for DINO's CLS attention)."""
        net = state.module
        outs = []
        for s in range(0, len(images), batch):
            x = torch.as_tensor(np.asarray(images[s:s + batch], np.float32), device=self.device)
            outs.append(net(x).float().cpu().numpy())
        feats = np.concatenate(outs).astype(np.float32)
        energy = np.linalg.norm(feats, axis=-1)
        lo = np.percentile(energy, 5)
        hi = np.percentile(energy, 95) + 1e-6
        attn = np.clip((energy - lo) / (hi - lo), 0.0, 1.0)
        return feats, attn.astype(np.float32)


def teacher_quality(state: TrainState, trainer: TeacherTrainer, scenes: List,
                    rng: np.random.Generator, n_pairs: int = 128) -> Dict[str, float]:
    """View invariance of the teacher on held-out scenes: the mean cosine
    of matched pixels and of randomly paired ones, and the share of
    matched pixels whose nearest neighbour in the other view's feature map
    lies within 2 px."""
    sims_pos, sims_rand, hits, total = [], [], 0, 0
    for sc in scenes:
        feats, _ = trainer.feature_maps(state, sc.images)
        v = len(sc.images)
        i, j = rng.choice(v, 2, replace=False)
        m = match_pixels(sc.poses, sc.focal, sc.depth, int(i), int(j), n_pairs, rng)
        if m is None:
            continue
        uv_a, uv_b = m
        fa, fb = feats[int(i)], feats[int(j)]
        ga = fa[np.clip((uv_a[:, 1] / 2).astype(int), 0, fa.shape[0] - 1),
                np.clip((uv_a[:, 0] / 2).astype(int), 0, fa.shape[1] - 1)]
        gb = fb[np.clip((uv_b[:, 1] / 2).astype(int), 0, fb.shape[0] - 1),
                np.clip((uv_b[:, 0] / 2).astype(int), 0, fb.shape[1] - 1)]
        na = ga / (np.linalg.norm(ga, axis=-1, keepdims=True) + 1e-6)
        nb = gb / (np.linalg.norm(gb, axis=-1, keepdims=True) + 1e-6)
        sims_pos.append(float(np.mean(np.sum(na * nb, -1))))
        sims_rand.append(float(np.mean(na @ nb[rng.permutation(len(nb))].T)))
        flat = fb.reshape(-1, fb.shape[-1])
        flat = flat / (np.linalg.norm(flat, axis=-1, keepdims=True) + 1e-6)
        nn_idx = np.argmax(na @ flat.T, axis=-1)
        ny, nx = nn_idx // fb.shape[1], nn_idx % fb.shape[1]
        err = np.hypot(ny * 2 - uv_b[:, 1], nx * 2 - uv_b[:, 0])
        hits += int((err <= 2.0).sum())
        total += len(err)
    return {"matched_cosine": float(np.mean(sims_pos)) if sims_pos else 0.0,
            "random_cosine": float(np.mean(sims_rand)) if sims_rand else 0.0,
            "teacher_corr_at2px": hits / total if total else 0.0}


def fit(tr: TeacherTrainer, state: TrainState, scenes: List, steps: int, seed: int = 0,
        log_every: int = 100, callback: Optional[Callable[[int, Dict], None]] = None
        ) -> TrainState:
    """`steps` steps of the CLI's loop: a scene and two of its views drawn
    from numpy's Generator(seed) until match_pixels finds their pairs, one
    train_step on them; printed every log_every steps and at the last.
    callback(step, metrics) after every step. The scenes' images are staged
    on the device once."""
    cfg = tr.cfg
    rng = np.random.default_rng(seed)
    imgs_dev = [torch.as_tensor(np.asarray(sc.images, np.float32), device=tr.device)
                for sc in scenes]
    for step in range(steps):
        while True:
            si = int(rng.integers(0, len(scenes)))
            sc = scenes[si]
            i, j = rng.choice(len(sc.images), 2, replace=False)
            m = match_pixels(sc.poses, sc.focal, sc.depth, int(i), int(j), cfg.n_pairs,
                             rng, cfg.depth_tol)
            if m is not None:
                break
        imgs = torch.stack([imgs_dev[si][int(i)], imgs_dev[si][int(j)]])
        state, metrics = tr.train_step(state, imgs, torch.as_tensor(m[0], device=tr.device),
                                       torch.as_tensor(m[1], device=tr.device))
        if callback is not None:
            callback(step, metrics)
        if step % log_every == 0 or step == steps - 1:
            print(f"[teacher] step {step} "
                  + " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items()), flush=True)
    return state


def save_teacher_state(path: str, state: TrainState) -> None:
    """`torch.save` of the step, the module's state_dict (batch statistics
    included) and the optimizer's state."""
    torch.save({"step": state.step, "params": state.module.state_dict(),
                "opt_state": state.optimizer.state_dict()}, path)


def load_teacher_state(path: str, state: TrainState) -> TrainState:
    """Fill `state` from a file of save_teacher_state, or from the JAX
    package's flax msgpack state ({"params", "extra": {"batch_stats"},
    "opt": (ScaleByAdamState, EmptyState)}): parameters, BatchNorm running
    statistics and the adam moments and count."""
    from real_robot_nerf_actor_tpu_torch.convert import (
        load_optax_state, read_flax_msgpack, teacher_to_state_dict)

    with open(path, "rb") as f:
        head = f.read(4)
    if head.startswith(b"PK"):          # a torch.save (zip) file
        payload = torch.load(path, map_location="cpu", weights_only=True)
        state.module.load_state_dict(payload["params"])
        state.optimizer.load_state_dict(payload["opt_state"])
        state.step = int(payload["step"])
        return state
    tree = read_flax_msgpack(path)
    sd = teacher_to_state_dict(tree["params"], tree.get("extra", {}).get("batch_stats"))
    state.module.load_state_dict(sd)
    adam_state = tree["opt"]["0"]
    load_optax_state(state.optimizer, (types.SimpleNamespace(**adam_state), ()))
    state.step = int(adam_state["count"])
    return state


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Train the geometry-guided contrastive teacher on scenes recorded with
    depth, report its view invariance, and dump its features (the
    counterpart of scripts/train_teacher.py)."""
    from real_robot_nerf_actor_tpu_torch.data.scene_dataset import load_scene, save_scene

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--data-root", required=True, help="dir of scene .npz")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--d-embed", type=int, default=64)
    ap.add_argument("--n-pairs", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--temperature", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--val-scenes", type=int, default=2,
                    help="LAST n scenes held out of teacher training for the "
                         "view-invariance metrics")
    ap.add_argument("--out", default=None, help="save the state (torch.save)")
    ap.add_argument("--resume", default=None,
                    help="load a state first: a --out file, or the JAX package's "
                         "msgpack (then --steps more steps; --steps 0 to only dump)")
    ap.add_argument("--dump", action="store_true",
                    help="write features + attn into every scene npz")
    ap.add_argument("--quality-out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    paths = sorted(glob.glob(os.path.join(args.data_root, "*.npz")))
    if not paths:
        raise FileNotFoundError(f"no scene npz files under {args.data_root}")
    scenes = [load_scene(p) for p in paths]
    if scenes[0].depth is None:
        raise ValueError("teacher training needs scenes recorded with depth")
    n_val = min(args.val_scenes, max(0, len(scenes) - 1))
    train_scenes = scenes[:len(scenes) - n_val]
    val_scenes = scenes[len(scenes) - n_val:]

    cfg = TeacherConfig(d_embed=args.d_embed, n_pairs=args.n_pairs, lr=args.lr,
                        temperature=args.temperature, steps=args.steps, seed=args.seed)
    tr = TeacherTrainer(cfg, device=args.device)
    state = tr.init_state(torch.Generator().manual_seed(args.seed))
    if args.resume:
        load_teacher_state(args.resume, state)
        print(f"[teacher] resumed {args.resume}")

    state = fit(tr, state, train_scenes, args.steps, args.seed)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        save_teacher_state(args.out, state)
        print(f"[teacher] saved {args.out}")

    q = teacher_quality(state, tr, val_scenes or train_scenes[-1:],
                        np.random.default_rng(123))
    print(f"[teacher] view-invariance: {q}")
    if args.quality_out:
        os.makedirs(os.path.dirname(args.quality_out) or ".", exist_ok=True)
        with open(args.quality_out, "w") as f:
            json.dump({"provenance": "in-repo geometry-contrastive teacher "
                       f"({args.steps} steps, seed {args.seed})", **q}, f, indent=1)

    if args.dump:
        for p, sc in zip(paths, scenes):
            sc.features, sc.cls_attn = tr.feature_maps(state, sc.images)
            save_scene(p, sc)
            print(f"{os.path.basename(p)}: features {sc.features.shape}")
        print("[teacher] features dumped into scene npz files")
    return q


if __name__ == "__main__":
    main()
