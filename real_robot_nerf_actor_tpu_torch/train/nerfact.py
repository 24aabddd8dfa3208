"""NeRF-Actor joint training: the PerAct BC loss plus a rendering loss of the
policy's voxel features (counterpart of the JAX package's
`train/nerfact.py`).

  SE(3) aug (the camera follows the scene's shift) -> voxelize
  -> PerceiverIO (UNet encoder, BatchNorm on batch statistics)
  -> BC heads and the voxel features d0
  -> NeuralRenderer.rendering_loss(d0 of sample 0, its ground-truth view)
  total = lambda_bc * BC + lambda_nerf * render -> one backward, one AdamW step

The state's module is `nn.ModuleDict(policy=PerceiverIO, nerf=VoxelNerfField)`,
so parameter names are `policy.*` and `nerf.*` as in the flax tree
{"policy", "nerf"} (convert.joint_to_state_dict); one `Optimizer` steps
both, so the global-norm clip spans both as optax's does, and the renderer
computes with the very field module the optimizer steps.

On a CUDA device, `conv_backend: pallas` runs the `final` conv on the k3
kernel and its VJP; `renderer.fused_gather: true` with
`ops.grid_sample.FUSED_LERP_BACKEND = "pallas"` runs each render pass's
latent lookup on the corner_lerp kernel and its VJP. Entry points run on
CUDA unless the caller passes device="cpu".

Not ported yet: the replay loaders and their evals (`replay_data`,
`multi_replay_data`, `make_replay_eval`) and `render_eval`'s saved panel.

    python -m real_robot_nerf_actor_tpu_torch.train.nerfact --steps 100
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from real_robot_nerf_actor_tpu_torch.data.synthetic import (
    make_camera_arc, make_synthetic_scene)
from real_robot_nerf_actor_tpu_torch.eval.metrics import psnr_np
from real_robot_nerf_actor_tpu_torch.models.blocks import init_weights
from real_robot_nerf_actor_tpu_torch.models.nerf_field import VoxelNerfField
from real_robot_nerf_actor_tpu_torch.models.perceiver import PerceiverConfig, PerceiverIO
from real_robot_nerf_actor_tpu_torch.ops.voxelize import voxelize
from real_robot_nerf_actor_tpu_torch.render.renderer import NeuralRenderer, RendererConfig
from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig, PerActTrainer
from real_robot_nerf_actor_tpu_torch.train.trainer import Optimizer, Trainer, TrainState


@dataclasses.dataclass(frozen=True)
class NerfActConfig:
    peract: PerActConfig = dataclasses.field(default_factory=lambda: PerActConfig(
        model=PerceiverConfig(input_encoder="unet", return_voxel_feat=True)))
    renderer: RendererConfig = dataclasses.field(default_factory=RendererConfig)
    lambda_bc: float = 1.0
    lambda_nerf: float = 10.0


class NerfActTrainer(PerActTrainer):
    """The PerAct trainer plus the joint rendering loss, on `device`."""

    def __init__(self, cfg: NerfActConfig, device="cuda"):
        if not cfg.peract.model.return_voxel_feat:
            raise ValueError("nerfact needs the PerceiverIO voxel_feat output "
                             "(peract.model.return_voxel_feat)")
        super().__init__(cfg.peract, device)
        self.jcfg = cfg
        self.renderer = NeuralRenderer(cfg.renderer, device=self.device)

    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """The policy's weights, then the field's, drawn as flax draws them
        (from `generator`, in that order), and one optimizer over both."""
        policy = PerceiverIO.initialized(self.cfg.model, generator)
        nerf = init_weights(VoxelNerfField(self.jcfg.renderer.field), generator)
        net = nn.ModuleDict({"policy": policy, "nerf": nerf}).to(self.device).train()
        return TrainState(step=0, module=net,
                          optimizer=Optimizer(self.cfg.train.optim, net.named_parameters()))

    def _renderer_of(self, state: TrainState) -> NeuralRenderer:
        self.renderer.field = state.module["nerf"]
        return self.renderer

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[torch.Tensor] = None,
                   ray_idx: Optional[torch.Tensor] = None,
                   render_draws: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on a PerAct batch (see PerActTrainer.train_step)
        that also carries gt_rgb (B,H,W,3), gt_pose (B,4,4), focal (B,) and
        optionally gt_embed (B,H,W,D), gt_depth (B,H,W). The rendering loss
        takes sample 0. draws: the SE(3) uniforms (B, 3); ray_idx and
        render_draws: `rendering_loss`'s draws; each drawn from `generator`
        when absent. Returns the state and the metrics (device tensors),
        `loss_total` among them. The profiler sees four ranges:
        train_step.forward (aug, voxelization, policy, BC losses), .render,
        .backward and .optimizer."""
        jc = self.jcfg
        net = state.module
        with record_function("train_step.forward"):
            net.zero_grad(set_to_none=True)
            out, aug, bc_total, metrics = self._forward_bc(net["policy"], batch, generator,
                                                           draws)
            gt_pose = batch["gt_pose"]
            if aug is not None:
                # the camera follows the scene's shift, so its pixels stay aligned
                gt_pose = gt_pose.clone()
                gt_pose[:, :3, 3] += aug.shift
        with record_function("train_step.render"):
            render_loss, rmetrics = self._renderer_of(state).rendering_loss(
                out[3][:1], batch["gt_rgb"][:1], gt_pose[:1], batch["focal"][0], generator,
                gt_embed=batch.get("gt_embed"), gt_depth=batch.get("gt_depth"),
                ray_idx=ray_idx, draws=render_draws)
            metrics.update(rmetrics)
            total = jc.lambda_bc * bc_total + jc.lambda_nerf * render_loss
            metrics["loss_total"] = total
        with record_function("train_step.backward"):
            total.backward()
        with record_function("train_step.optimizer"):
            state.optimizer.step()
        state.step += 1
        return state, {k: m.detach() for k, m in metrics.items()}

    # ---------------------------------------------------------------- data
    def synthetic_data(self, batch_size: int = 1, seed: int = 0,
                       lang_embs: Optional[np.ndarray] = None
                       ) -> Iterator[Dict[str, torch.Tensor]]:
        """PerAct synthetic batches plus one view of the scene (the JAX
        package's numpy draws, so the same batches): a z-buffered splat of
        the scene's points from the first pose of `make_camera_arc`, its
        pose and focal, and a small random gt_embed. The view is put on the
        device once."""
        rc = self.jcfg.renderer
        scene = make_synthetic_scene(seed=seed)
        pose = make_camera_arc(1)[0]
        h, w = rc.image_height, rc.image_width
        focal = 0.6 * max(h, w)
        gt_rgb = _splat_view(scene, pose, h, w, focal)
        rng = np.random.default_rng(seed + 1)
        gt_embed = rng.standard_normal((h, w, rc.field.d_embed)).astype(np.float32) * 0.01

        def per_sample(a):
            return torch.as_tensor(np.broadcast_to(a, (batch_size,) + a.shape).copy()
                                   ).to(self.device)

        view = {"gt_rgb": per_sample(gt_rgb), "gt_pose": per_sample(pose),
                "focal": torch.full((batch_size,), focal, dtype=torch.float32,
                                    device=self.device),
                "gt_embed": per_sample(gt_embed)}
        for batch in super().synthetic_data(batch_size, seed, lang_embs):
            yield {**batch, **view}

    # ---------------------------------------------------------------- eval
    def render_eval(self, state: TrainState, step: int,
                    batch: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, float]:
        """The whole ground-truth view rendered from the policy's voxel
        features (eval mode, no grad): PSNR over the image and over its
        foreground (pixels whose colours sum above 0.02), as the JAX
        `render_eval` returns them. Its comparison panel is not ported."""
        c = self.cfg
        if batch is None:
            batch = next(self.synthetic_data(batch_size=1))
        net = state.module
        with torch.no_grad():
            vox = voxelize(batch["points"], batch["colors"], self.bounds, c.voxelizer,
                           valid=batch["valid"])
            d0 = net["policy"](vox, batch["proprio"], batch["lang"])[3]
            rgb = self._renderer_of(state).render_image(
                d0[:1], batch["gt_pose"][:1], batch["focal"][0],
                torch.Generator(device=self.device).manual_seed(step))[0]
        gt = batch["gt_rgb"][0].cpu().numpy()
        rgb_np = rgb.float().cpu().numpy()
        fg = gt.sum(-1) > 0.02
        return {"eval_psnr": psnr_np(rgb_np, gt),
                "eval_psnr_fg": psnr_np(rgb_np[fg], gt[fg]) if fg.any() else 0.0}

    def make_trainer(self, data: Optional[Iterator] = None) -> Trainer:
        return Trainer(self.cfg.train, self.train_step, data or self.synthetic_data(),
                       self.init_state, eval_fn=self.render_eval)


def _splat_view(scene, pose: np.ndarray, h: int, w: int, focal: float) -> np.ndarray:
    """Project the scene's points into the view and splat their colours
    (z-buffered: far points first, near ones overwrite)."""
    w2c = np.linalg.inv(pose)
    p_cam = scene.points @ w2c[:3, :3].T + w2c[:3, 3]
    z = -p_cam[:, 2]
    keep = z > 1e-3
    p_cam, z = p_cam[keep], z[keep]
    cols = (scene.colors[keep] + 1.0) / 2.0
    u = (focal * p_cam[:, 0] / z + w / 2).astype(np.int32)
    v = (-focal * p_cam[:, 1] / z + h / 2).astype(np.int32)
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    u, v, z, cols = u[ok], v[ok], z[ok], cols[ok]
    order = np.argsort(-z)
    img = np.zeros((h, w, 3), np.float32)
    img[v[order], u[order]] = cols[order]
    return img


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    """NeRF-Actor joint training on the bundled synthetic scene (the
    counterpart of scripts/train_nerfact.py without --data-root). Configs
    are JSON (YAML where PyYAML is installed) with dot-path overrides."""
    from real_robot_nerf_actor_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--config", default=None, help="JSON/YAML NerfActConfig")
    ap.add_argument("-o", "--override", action="append", default=[],
                    help="dot-path config overrides, e.g. peract.train.optim.lr=3e-4")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(NerfActConfig, args.config, args.override)
    tcfg = cfg.peract.train
    if args.steps is not None:
        tcfg = dataclasses.replace(tcfg, num_steps=args.steps)
    tcfg = dataclasses.replace(tcfg, ckpt_dir=args.ckpt_dir or tcfg.ckpt_dir,
                               log_dir=args.log_dir or tcfg.log_dir)
    cfg = dataclasses.replace(cfg, peract=dataclasses.replace(cfg.peract, train=tcfg))
    tr = NerfActTrainer(cfg, device=args.device)
    trainer = tr.make_trainer(tr.synthetic_data(batch_size=args.batch_size))
    return trainer.run(resume=not args.no_resume)


if __name__ == "__main__":
    main()
