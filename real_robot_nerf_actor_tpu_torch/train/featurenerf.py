"""FeatureNeRF pretraining: pixelNeRF plus foundation-feature distillation
(counterpart of the JAX package's `train/featurenerf.py`).

One step, on one scene:
  - rays: a random view per ray and a random pixel in it (inside the
    view's bbox while step < no_bbox_step, where the batch has bboxes);
  - source views `src_ord` (1..k of `nviews`), encoded with the 2-D
    encoder in inference mode (its BatchNorm statistics never move);
  - coarse/fine render of the rays (PixelNerfRenderer, train=True arms the
    Aug-NeRF hooks);
  - losses: lambda_coarse/fine * MSE(rgb) + lambda_embed * MSE(embed) of
    both levels against the teacher features sampled at the ray pixels
    (`_sample_view_maps`: grid_sample align_corners=False, zero padding,
    each axis normalised by its own size) + lambda_attn *
    attention_norm_loss against the teacher's cls attention + lambda_coord
    * MSE(coord residual, 0) of both levels; `mask_feat` zeroes the
    targets on background pixels;
  - one backward, one AdamW step (train/trainer.py `Optimizer`).
Spans (`utils/profiling.named_scope`): featurenerf.encode, .render (rays,
render, losses), .backward and .optimizer; inside .render, on each of the
two passes, .sample, .project, .field and .composite (the renderer's and
the field's).

`scene_data` stages every scene on the device once; per step only
`src_ord` changes, drawn with numpy in the JAX package's order. Every draw
of the step can be passed in (`draws=`: v, y, x, u_bbox, src_ord;
`render_draws=`: the renderer's), else it comes from the generator.
Entry points run on CUDA unless the caller passes device="cpu".

    python -m real_robot_nerf_actor_tpu_torch.train.featurenerf \\
        --config configs/featurenerf.yaml --data-root DIR --steps 100
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from real_robot_nerf_actor_tpu_torch.models.blocks import init_weights
from real_robot_nerf_actor_tpu_torch.models.pixelnerf import PixelNerfConfig, PixelNerfNet
from real_robot_nerf_actor_tpu_torch.ops.rays import gen_rays
from real_robot_nerf_actor_tpu_torch.render.pixelnerf_renderer import (
    PixelNerfRenderer, PixelNerfRendererConfig)
from real_robot_nerf_actor_tpu_torch.render.renderer import psnr
from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device
from real_robot_nerf_actor_tpu_torch.train.trainer import (
    Optimizer, TrainConfig, Trainer, TrainState)
from real_robot_nerf_actor_tpu_torch.utils.profiling import named_scope


@dataclasses.dataclass(frozen=True)
class FeatureNerfConfig:
    model: PixelNerfConfig = dataclasses.field(default_factory=PixelNerfConfig)
    renderer: PixelNerfRendererConfig = dataclasses.field(
        default_factory=PixelNerfRendererConfig)
    ray_batch_size: int = 512
    z_near: float = 1.2
    z_far: float = 4.0
    lambda_coarse: float = 1.0
    lambda_fine: float = 1.0
    lambda_embed: float = 0.1
    lambda_attn: float = 0.1
    lambda_coord: float = 0.0
    no_bbox_step: int = 100_000   # bbox-biased sampling until this step
    nviews: Tuple[int, ...] = (1,)
    mask_feat: bool = False
    mask_white_bkgd: bool = True
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def attention_norm_loss(embed: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """MSE between the L2-normalised per-ray means of the rendered
    embedding and of the teacher cls attention."""
    e = embed.mean(dim=-1)
    a = attn.mean(dim=-1)
    e = e / torch.clamp(torch.linalg.vector_norm(e), min=1e-12)
    a = a / torch.clamp(torch.linalg.vector_norm(a), min=1e-12)
    return torch.mean((e - a) ** 2)


def _sample_view_maps(maps: torch.Tensor, v, y, x, image_shape: Tuple[int, int]) -> torch.Tensor:
    """Bilinear samples of per-view maps (NV, hf, wf, C) at pixels (v, y, x)
    of an (H, W) image: grid_sample's align_corners=False and zero padding,
    x normalised by W and y by H. Returns (R, C)."""
    h, w = image_shape
    _, hf, wf, _ = maps.shape
    yf = y.to(torch.float32) / h * hf - 0.5
    xf = x.to(torch.float32) / w * wf - 0.5
    y0, x0 = torch.floor(yf), torch.floor(xf)
    ty, tx = (yf - y0)[:, None], (xf - x0)[:, None]

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < hf) & (xi >= 0) & (xi < wf)
        yc = yi.clamp(0, hf - 1).long()
        xc = xi.clamp(0, wf - 1).long()
        return maps[v, yc, xc] * inside[:, None].to(maps.dtype)

    v0 = tap(y0, x0) * (1 - tx) + tap(y0, x0 + 1) * tx
    v1 = tap(y0 + 1, x0) * (1 - tx) + tap(y0 + 1, x0 + 1) * tx
    return v0 * (1 - ty) + v1 * ty


class FeatureNerfTrainer:
    """The FeatureNeRF step on `device`. lambda_coord > 0 turns on the
    field's coord head (regress_coord), as in the JAX package."""

    def __init__(self, cfg: FeatureNerfConfig, device="cuda"):
        if cfg.lambda_coord > 0 and not cfg.model.regress_coord:
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, regress_coord=True))
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """The field's weights drawn as flax initialises them (from
        `generator`), on the device, and the optimizer."""
        net = init_weights(PixelNerfNet(self.cfg.model), generator).to(self.device)
        return TrainState(step=0, module=net,
                          optimizer=Optimizer(self.cfg.train.optim, net.named_parameters()))

    def renderer(self, net: PixelNerfNet) -> PixelNerfRenderer:
        return PixelNerfRenderer(self.cfg.renderer, net)

    def encode(self, net: PixelNerfNet, images: torch.Tensor, poses: torch.Tensor,
               focal) -> tuple:
        """The renderer's `enc` of source views images (NS, H, W, 3) in
        [0, 1] with poses (NS, 4, 4) camera-to-world: the latent in
        inference mode, world-to-camera poses, [f, -f], c = 0, (H, W)."""
        latent = net.encode(images * 2.0 - 1.0)
        focal = torch.as_tensor(focal, dtype=torch.float32, device=images.device)
        return (latent, torch.linalg.inv(poses), torch.stack([focal, -focal]),
                torch.zeros(2, device=images.device), tuple(images.shape[1:3]))

    # ------------------------------------------------------------- sampling
    def _sample_pixels(self, batch: Mapping[str, torch.Tensor], step: int,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Mapping[str, torch.Tensor]] = None):
        """(v, y, x) int64 (R,) each: a random view per ray, and a random
        pixel, inside the view's bbox (cmin, rmin, cmax, rmax) while
        step < no_bbox_step where the batch has bboxes. draws: v, y, x
        (R,) and u_bbox (R, 2) uniforms."""
        cfg = self.cfg
        nv, h, w, _ = batch["images"].shape
        r = cfg.ray_batch_size
        d = draws or {}
        dev = batch["images"].device

        def randint(name, high):
            if name in d:
                return d[name].to(device=dev, dtype=torch.long)
            gdev = generator.device if generator is not None else dev
            return torch.randint(0, high, (r,), generator=generator, device=gdev).to(dev)

        v, y, x = randint("v", nv), randint("y", h), randint("x", w)
        if "bbox" in batch and cfg.no_bbox_step > 0 and step < cfg.no_bbox_step:
            bb = batch["bbox"][v].to(torch.float32)
            if "u_bbox" in d:
                ub = d["u_bbox"].to(dev)
            else:
                gdev = generator.device if generator is not None else dev
                ub = torch.rand((r, 2), generator=generator, device=gdev).to(dev)
            x = (ub[:, 0] * (bb[:, 2] + 1 - bb[:, 0]) + bb[:, 0]).long()
            y = (ub[:, 1] * (bb[:, 3] + 1 - bb[:, 1]) + bb[:, 1]).long()
        return v, y, x

    # --------------------------------------------------------------- losses
    def compute_losses(self, net: PixelNerfNet, batch: Mapping[str, torch.Tensor], v, y, x,
                       src_ord: torch.Tensor, generator: Optional[torch.Generator] = None,
                       render_draws: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The step's loss and metrics for sampled ray pixels (v, y, x) and
        source views src_ord."""
        cfg = self.cfg
        _, h, w, _ = batch["images"].shape
        with named_scope("featurenerf.encode"):
            enc = self.encode(net, batch["images"][src_ord], batch["poses"][src_ord],
                              batch["focal"])
        with named_scope("featurenerf.render"):
            rays = gen_rays(batch["poses"], w, h, batch["focal"], cfg.z_near,
                            cfg.z_far)[v, y, x]
            out = self.renderer(net).render_rays(enc, rays, generator, train=True,
                                                 draws=render_draws)
            gt_rgb = batch["images"][v, y, x]
            coarse, fine = out["coarse"], out.get("fine", out["coarse"])
            loss_rgb = (cfg.lambda_coarse * torch.mean((coarse.rgb - gt_rgb) ** 2)
                        + cfg.lambda_fine * torch.mean((fine.rgb - gt_rgb) ** 2))
            loss = loss_rgb
            metrics = {"loss_rgb": loss_rgb, "psnr": psnr(fine.rgb, gt_rgb)}
            fg = None
            if cfg.mask_feat:
                bkgd = 1.0 if cfg.mask_white_bkgd else 0.0
                fg = 1.0 - torch.all(gt_rgb == bkgd, dim=-1).to(torch.float32)
            if cfg.lambda_embed > 0 and "features" in batch:
                gt_embed = _sample_view_maps(batch["features"], v, y, x, (h, w))
                if fg is not None:
                    gt_embed = gt_embed * fg[:, None]
                loss_embed = cfg.lambda_embed * (torch.mean((coarse.embed - gt_embed) ** 2)
                                                 + torch.mean((fine.embed - gt_embed) ** 2))
                loss = loss + loss_embed
                metrics["loss_embed"] = loss_embed
            if cfg.lambda_attn > 0 and "cls_attn" in batch:
                gt_attn = _sample_view_maps(batch["cls_attn"], v, y, x, (h, w))
                if fg is not None:
                    gt_attn = gt_attn * fg[:, None]
                loss_attn = cfg.lambda_attn * (attention_norm_loss(coarse.embed, gt_attn)
                                               + attention_norm_loss(fine.embed, gt_attn))
                loss = loss + loss_attn
                metrics["loss_attn"] = loss_attn
            if cfg.lambda_coord > 0:
                fine_coord = out.get("fine_coord", out["coarse_coord"])
                loss_coord = cfg.lambda_coord * (torch.mean(out["coarse_coord"] ** 2)
                                                 + torch.mean(fine_coord ** 2))
                loss = loss + loss_coord
                metrics["loss_coord"] = loss_coord
            metrics["loss"] = loss
        return loss, metrics

    # ----------------------------------------------------------------- step
    def train_step(self, state: TrainState, batch: Mapping[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Mapping[str, torch.Tensor]] = None,
                   render_draws: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on a scene batch: images (NV, H, W, 3) in
        [0, 1], poses (NV, 4, 4) camera-to-world, focal (), and optionally
        features (NV, hf, wf, D), cls_attn (NV, ha, wa, A), bbox (NV, 4),
        src_ord (NS,) (else one random view: draws["src_ord"] or the
        generator). Returns the state and the metrics (device tensors)."""
        net = state.module
        d = draws or {}
        if "src_ord" in batch:
            src_ord = batch["src_ord"]
        elif "src_ord" in d:
            src_ord = d["src_ord"]
        else:
            nv = batch["images"].shape[0]
            gdev = generator.device if generator is not None else batch["images"].device
            src_ord = torch.randint(0, nv, (1,), generator=generator, device=gdev)
        src_ord = src_ord.to(device=batch["images"].device, dtype=torch.long)
        v, y, x = self._sample_pixels(batch, state.step, generator, d)
        net.zero_grad(set_to_none=True)
        loss, metrics = self.compute_losses(net, batch, v, y, x, src_ord, generator,
                                            render_draws)
        with named_scope("featurenerf.backward"):
            loss.backward()
        with named_scope("featurenerf.optimizer"):
            state.optimizer.step()
        state.step += 1
        return state, {k: m.detach() for k, m in metrics.items()}

    # ---------------------------------------------------------------- data
    def scene_data(self, scenes, seed: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        """Scene batches forever, with every scene's images, poses, focal,
        features and cls attention (NHWC: a (N, heads, hf, wf) map is
        transposed, a (N, hf, wf) map gets a channel) put on the device
        once; per step one scene and its src_ord are drawn with numpy."""
        rng = np.random.default_rng(seed)
        nviews = self.cfg.nviews
        dev = self.device
        staged = []
        for sc in scenes:
            b = {"images": torch.as_tensor(np.asarray(sc.images, np.float32), device=dev),
                 "poses": torch.as_tensor(np.asarray(sc.poses, np.float32), device=dev),
                 "focal": torch.tensor(float(sc.focal), dtype=torch.float32, device=dev)}
            if sc.features is not None:
                b["features"] = torch.as_tensor(np.asarray(sc.features, np.float32),
                                                device=dev)
            if sc.cls_attn is not None:
                attn = np.asarray(sc.cls_attn, np.float32)
                attn = attn[..., None] if attn.ndim == 3 else attn.transpose(0, 2, 3, 1)
                b["cls_attn"] = torch.as_tensor(np.ascontiguousarray(attn), device=dev)
            staged.append(b)
        while True:
            b = staged[int(rng.integers(0, len(staged)))]
            nv = b["images"].shape[0]
            ns = min(int(nviews[rng.integers(0, len(nviews))]), nv)
            yield dict(b, src_ord=torch.as_tensor(rng.choice(nv, size=ns, replace=False),
                                                  dtype=torch.long, device=dev))

    def make_trainer(self, data) -> Trainer:
        return Trainer(self.cfg.train, self.train_step, data, self.init_state)


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    """FeatureNeRF pretraining over a directory of scene npz files (the
    counterpart of scripts/train_featurenerf.py); without --data-root, four
    synthetic scenes are written to a temporary directory first."""
    import os
    import tempfile

    from real_robot_nerf_actor_tpu_torch.data.scene_dataset import (
        SceneDataset, synthesize_scene_npz)
    from real_robot_nerf_actor_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--data-root", default=None,
                    help="dir of scene npz files; generated if absent")
    ap.add_argument("--config", default=None, help="JSON/YAML FeatureNerfConfig")
    ap.add_argument("-o", "--override", action="append", default=[])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(FeatureNerfConfig, args.config, args.override)
    tcfg = cfg.train
    if args.steps is not None:
        tcfg = dataclasses.replace(tcfg, num_steps=args.steps)
    tcfg = dataclasses.replace(tcfg, ckpt_dir=args.ckpt_dir or tcfg.ckpt_dir,
                               log_dir=args.log_dir or tcfg.log_dir)
    cfg = dataclasses.replace(cfg, train=tcfg)
    tr = FeatureNerfTrainer(cfg, device=args.device)

    root = args.data_root
    if root is None:
        root = tempfile.mkdtemp(prefix="fnerf_scenes_")
        for i in range(4):
            synthesize_scene_npz(os.path.join(root, f"scene_{i}.npz"), seed=i,
                                 d_feature=cfg.model.d_embed)
        print(f"generated synthetic scenes -> {root}")
    scenes = SceneDataset(root, split="train")
    return tr.make_trainer(tr.scene_data(scenes)).run()


if __name__ == "__main__":
    main()
