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

Data: `synthetic_data`, or recorded demos (`replay_data`, and
`multi_replay_data` across kitchens x tasks with each task's language
tokens), which check the recording against the renderer config. Evals:
`render_eval` (PSNR of the ground-truth view), and for recorded demos
`make_replay_eval` / `make_multi_replay_eval` (render PSNR on the training
and held-out views, the BC argmax decode of every transition, the
zero-language ablation, `bc_score` / `bc_render_score` for
`TrainConfig.best_key`). Every render takes the field's current weights:
the kernels' pack is rebuilt from them (`_renderer_of`), and static int8
scales are calibrated once per scene. The decode and the renders run under
inference_mode, so the policy's forward kernels and the field's serving
kernels run where their knobs are on. With a save directory
(`--eval-save-dir`) each eval writes the JAX package's comparison panels
(utils/visualize.py): `render_{step:06d}.png`, and per kitchen
`k{kid}_render_{step:06d}.png`.

    python -m real_robot_nerf_actor_tpu_torch.train.nerfact --steps 100
    python -m real_robot_nerf_actor_tpu_torch.train.nerfact --multi-root DIR
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from real_robot_nerf_actor_tpu_torch.data.synthetic import (
    make_camera_arc, make_synthetic_scene)
from real_robot_nerf_actor_tpu_torch.eval.metrics import psnr_np
from real_robot_nerf_actor_tpu_torch.models.blocks import init_weights
from real_robot_nerf_actor_tpu_torch.models.nerf_field import VoxelNerfField
from real_robot_nerf_actor_tpu_torch.models.perceiver import PerceiverConfig, PerceiverIO
from real_robot_nerf_actor_tpu_torch.ops.action_codec import (
    choose_highest_action, discretize_action)
from real_robot_nerf_actor_tpu_torch.ops.geometry import point_to_voxel_index
from real_robot_nerf_actor_tpu_torch.ops.voxelize import voxelize
from real_robot_nerf_actor_tpu_torch.render.renderer import NeuralRenderer, RendererConfig
from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig, PerActTrainer
from real_robot_nerf_actor_tpu_torch.train.trainer import Optimizer, Trainer, TrainState
from real_robot_nerf_actor_tpu_torch.utils.profiling import named_scope


@dataclasses.dataclass(frozen=True)
class NerfActConfig:
    peract: PerActConfig = dataclasses.field(default_factory=lambda: PerActConfig(
        model=PerceiverConfig(input_encoder="unet", return_voxel_feat=True)))
    renderer: RendererConfig = dataclasses.field(default_factory=RendererConfig)
    lambda_bc: float = 1.0
    lambda_nerf: float = 10.0


class NerfActTrainer(PerActTrainer):
    """The PerAct trainer plus the joint rendering loss, on `device`.
    `ray_split` (set by parallel.train_dp for a ray-parallel step) maps the
    render loss's inputs (sample 0's d0 and view, the rays and their draws)
    to this rank's share; None renders them as they are."""

    ray_split: Optional[Callable] = None

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
        """The renderer on the state's field, with the serving kernels' pack
        rebuilt from the field's weights as they are now (an optimizer step
        or a checkpoint load moves them; the JAX renderer packs from the
        live parameters on every call). Without a kernel backend there is
        nothing to pack."""
        self.renderer.field = state.module["nerf"]
        self.renderer._pack()
        return self.renderer

    def _calibrate(self, rend: NeuralRenderer, d0, pose, focal, step: int) -> None:
        """Static int8 activation scales of one scene (the frame's rays from
        `pose`), where the field asks for them; draws seeded with `step`."""
        f = rend.cfg.field
        if f.mlp_backend == "pallas_int8" and f.int8_static_act:
            rend.calibrate_int8_act(d0, rend.frame_rays(pose, focal),
                                    generator=torch.Generator(device=self.device).manual_seed(step))

    def _render(self, rend: NeuralRenderer, d0, pose, focal, step: int, draws=None):
        """render_image of one view, its draws from a generator seeded with
        `step` unless `draws` (one mapping a tile) gives them."""
        return rend.render_image(d0, pose, focal,
                                 torch.Generator(device=self.device).manual_seed(step),
                                 draws=draws)

    def _policy_out(self, state: TrainState, cloud, lang):
        """The policy's eval-mode outputs under inference_mode for a cloud
        (points, colors, valid, proprio), each with a leading batch dim."""
        pts, cols, valid, proprio = cloud
        with torch.inference_mode():
            vox = voxelize(pts, cols, self.bounds, self.cfg.voxelizer, valid=valid)
            return state.module["policy"](vox, proprio, lang)

    def losses(self, state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               draws: Optional[torch.Tensor] = None,
               ray_idx: Optional[torch.Tensor] = None,
               render_draws: Optional[Mapping[str, torch.Tensor]] = None):
        """The step's forward: (total loss, metrics, the policy's outputs),
        the metrics still in the graph (see train_step for the arguments).
        Spans: train_step.forward (aug, voxelization, policy, BC losses,
        each its own span: see PerActTrainer._forward_bc) and .render."""
        jc = self.jcfg
        with named_scope("train_step.forward"):
            out, aug, bc_total, metrics = self._forward_bc(state.module["policy"], batch,
                                                           generator, draws)
            gt_pose = batch["gt_pose"]
            if aug is not None:
                # the camera follows the scene's shift, so its pixels stay aligned
                gt_pose = gt_pose.clone()
                gt_pose[:, :3, 3] += aug.shift
        with named_scope("train_step.render"):
            view = [None if t is None else t[:1] for t in (
                out[3], batch["gt_rgb"], gt_pose, batch["focal"], batch.get("gt_embed"),
                batch.get("gt_depth"))]
            denominator = None
            if self.ray_split is not None:
                view, ray_idx, render_draws, denominator = self.ray_split(
                    view, ray_idx, render_draws)
            d0, gt_rgb, pose, focal, gt_embed, gt_depth = view
            render_loss, rmetrics = self._renderer_of(state).rendering_loss(
                d0, gt_rgb, pose, focal[0], generator, gt_embed=gt_embed, gt_depth=gt_depth,
                ray_idx=ray_idx, draws=render_draws, depth_denominator=denominator)
            metrics.update(rmetrics)
            total = jc.lambda_bc * bc_total + jc.lambda_nerf * render_loss
            metrics["loss_total"] = total
        return total, metrics, out

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
        `loss_total` among them. Spans (`utils/profiling`): train_step
        around the step, in it train_step.forward (aug, voxelization,
        policy, BC losses), .render, .backward (the VJPs' own spans,
        backward.*, open inside it, on autograd's device thread on CUDA)
        and .optimizer (optimizer.finite_check in it)."""
        with named_scope("train_step"):
            state.module.zero_grad(set_to_none=True)
            total, metrics, _ = self.losses(state, batch, generator, draws, ray_idx,
                                            render_draws)
            with named_scope("train_step.backward"):
                total.backward()
            with named_scope("train_step.optimizer"):
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

    def replay_data(self, root: str, n_demos: int, batch_size: int = 1, seed: int = 0,
                    lang_embs=None, exclude_demos: Tuple[int, ...] = (),
                    sample_mode: str = "uniform") -> Iterator[Dict[str, torch.Tensor]]:
        """Joint-training batches from recorded demos: the PerAct fields and
        each keyframe's ground-truth view, pose and focal (and teacher embed
        and depth where recorded). Checks the recording against the
        renderer config first."""
        self._check_recordings([{"root": root, "n_demos": n_demos}])
        return super().replay_data(root, n_demos, batch_size, seed, lang_embs,
                                   with_views=True, exclude_demos=exclude_demos,
                                   sample_mode=sample_mode)

    def multi_replay_data(self, entries, batch_size: int = 1, seed: int = 0,
                          with_views: bool = True, sample_mode: str = "uniform"
                          ) -> Iterator[Dict[str, torch.Tensor]]:
        """Joint-training batches across kitchens x tasks: each sample
        carries its task's language tokens and its kitchen's view, pose and
        focal. Checks every recording against the renderer config."""
        if with_views:
            self._check_recordings(entries)
        return super().multi_replay_data(entries, batch_size, seed, with_views=with_views,
                                         sample_mode=sample_mode)

    def _check_recordings(self, entries) -> None:
        from real_robot_nerf_actor_tpu_torch.data.replay import ReplaySource

        rc = self.jcfg.renderer
        for e in entries:
            src = ReplaySource(e["root"], e["n_demos"])
            if not src.has_views:
                raise ValueError(f"{e['root']} carries no ground-truth views; joint "
                                 "training needs real*/rgb*.png")
            v0 = src.view(0, 0)
            h, w = v0["rgb"].shape[:2]
            if (h, w) != (rc.image_height, rc.image_width):
                raise ValueError(
                    f"{e['root']}: recorded views are {h}x{w} but the renderer config is "
                    f"{rc.image_height}x{rc.image_width}: set renderer.image_height/width "
                    "to match the recording")
            if "embed" in v0 and v0["embed"].shape[-1] != rc.field.d_embed:
                raise ValueError(f"{e['root']}: recorded teacher embeds have "
                                 f"d={v0['embed'].shape[-1]} but field.d_embed="
                                 f"{rc.field.d_embed}")

    # ---------------------------------------------------------------- eval
    def render_eval(self, state: TrainState, step: int,
                    batch: Optional[Dict[str, torch.Tensor]] = None,
                    draws: Optional[List[Mapping[str, torch.Tensor]]] = None,
                    save_dir: Optional[str] = None) -> Dict[str, float]:
        """The whole ground-truth view of sample 0 rendered from the
        policy's voxel features: PSNR over the image and over its
        foreground (pixels whose colours sum above 0.02), as the JAX
        `render_eval` returns them; static int8 scales are calibrated on
        this view first. draws: render_image's, one mapping a tile (else
        from a generator seeded with `step`). save_dir: the gt / render /
        depth / embed panel goes to save_dir/render_{step:06d}.png."""
        if batch is None:
            batch = next(self.synthetic_data(batch_size=1))
        d0 = self._policy_out(state, (batch["points"][:1], batch["colors"][:1],
                                      batch["valid"][:1], batch["proprio"][:1]),
                              batch["lang"][:1])[3]
        rend = self._renderer_of(state)
        pose, focal = batch["gt_pose"][:1], batch["focal"][0]
        self._calibrate(rend, d0, pose, focal, step)
        rgb, embed, depth = self._render(rend, d0, pose, focal, step, draws)
        gt = batch["gt_rgb"][0].cpu().numpy()
        rgb_np = rgb.float().cpu().numpy()
        fg = gt.sum(-1) > 0.02
        p = psnr_np(rgb_np, gt)
        if save_dir:
            _save_panel(save_dir, f"render_{step:06d}.png", gt, rgb_np, depth, embed, p)
        return {"eval_psnr": p,
                "eval_psnr_fg": psnr_np(rgb_np[fg], gt[fg]) if fg.any() else 0.0}

    def _stage_transitions(self, src, n_demos: int, exclude=()):
        """Every transition (d, k -> k+1) of a recording staged on the
        device once: (d, k, (points, colors, valid, proprio) each (1, ...),
        the wanted action {trans (3,), rot_grip (4,)} numpy, d not in
        exclude)."""
        from real_robot_nerf_actor_tpu_torch.data.replay import pad_point_cloud

        c, dev = self.cfg, self.device
        out = []
        for d in range(n_demos):
            demo = src.demos[d]
            nk = demo.num_keyframes
            xyz = torch.as_tensor(demo.xyz, device=dev)
            dd = discretize_action(xyz, torch.as_tensor(demo.rotation, device=dev),
                                   torch.as_tensor(demo.gripper_open, device=dev),
                                   torch.ones((nk,), device=dev), self.bounds,
                                   c.model.voxel_size, c.rotation_resolution)
            rg = dd.rot_grip.cpu().numpy()
            ti = point_to_voxel_index(xyz, c.model.voxel_size, self.bounds).cpu().numpy()
            for k in range(nk - 1):
                pts, cols, valid = pad_point_cloud(src.pointcloud(d, k),
                                                   c.voxelizer.max_num_coords)
                proprio = np.concatenate([ti[k].astype(np.float32),
                                          rg[k].astype(np.float32)])[None]
                cloud = tuple(torch.as_tensor(a).to(dev)[None] for a in (pts, cols, valid))
                cloud += (torch.as_tensor(proprio).to(dev),)
                out.append((d, k, cloud, {"trans": ti[k + 1], "rot_grip": rg[k + 1]},
                            d not in exclude))
        return out

    def _decode(self, state: TrainState, cloud, lang):
        """Argmax decode of one transition: (trans (3,), rot_grip (4,)) numpy."""
        out = self._policy_out(state, cloud, lang)
        coords, rot_grip, _ = choose_highest_action(out[0], out[1], out[2],
                                                    self.cfg.rotation_resolution)
        return coords[0].cpu().numpy(), rot_grip[0].cpu().numpy()

    def make_replay_eval(self, root: str, n_demos: int, exclude_demos: Tuple[int, ...] = (),
                         save_dir: Optional[str] = None,
                         eval_batch: Optional[Dict[str, torch.Tensor]] = None,
                         render_draws: Optional[Callable[[int], list]] = None):
        """Eval closure for training on one recording. Per eval:
          - render_eval on eval_batch (a synthetic batch without one);
          - the BC argmax decode of every transition: exact voxel match,
            within one voxel, mean voxel distance, rot within one bin, grip,
            as bc_train_* and, for exclude_demos, bc_holdout_*;
          - render PSNR on the held-out view where recorded;
          - bc_score = (exact + within1) / 2 - dist / 500 and
            bc_render_score = bc_score + 0.01 * eval_psnr_holdout.
        render_draws(step): render_image's draws for every render of that
        eval (else generators seeded with the step). save_dir: render_eval's
        panel."""
        from real_robot_nerf_actor_tpu_torch.data.replay import ReplaySource

        c = self.cfg
        src = ReplaySource(root, n_demos)
        lang = torch.zeros((1, c.model.lang_max_seq_len, c.model.lang_emb_dim),
                           device=self.device)
        transitions = self._stage_transitions(src, n_demos, set(exclude_demos))
        nrc = c.model.num_rotation_classes
        holdout_view = src.holdout_view(0, 0) if src.has_holdout else None
        holdout_pose = (torch.as_tensor(src.holdout_pose)[None].to(self.device)
                        if holdout_view is not None else None)

        def eval_fn(state: TrainState, step: int) -> Dict[str, float]:
            draws = render_draws(step) if render_draws is not None else None
            metrics = self.render_eval(state, step, batch=eval_batch, draws=draws,
                                       save_dir=save_dir)
            stats = {True: _blank(), False: _blank()}
            for d, k, cloud, want, trn in transitions:
                _score(stats[trn], *self._decode(state, cloud, lang), want, nrc)
            _emit(metrics, "bc_train", stats[True])
            _emit(metrics, "bc_holdout", stats[False])
            metrics["bc_score"] = _bc_score(stats[True])
            if holdout_view is not None:
                d0_, k0, cloud, _, _ = transitions[0]
                feat = self._policy_out(state, cloud, lang)[3]
                rend = self._renderer_of(state)
                focal = torch.tensor(src.focal, device=self.device)
                self._calibrate(rend, feat, holdout_pose, focal, step)
                rgb = self._render(rend, feat, holdout_pose, focal, step, draws)[0]
                metrics["eval_psnr_holdout"] = psnr_np(rgb.float().cpu().numpy(),
                                                       src.holdout_view(d0_, k0)["rgb"])
            metrics["bc_render_score"] = metrics["bc_score"] + 0.01 * float(
                metrics.get("eval_psnr_holdout", 0.0))
            return metrics

        return eval_fn

    def make_multi_replay_eval(self, entries, save_dir: Optional[str] = None,
                               render_draws: Optional[Callable[[int], list]] = None):
        """Eval closure for the multi-kitchen multi-task dataset. Per eval:
          - per kitchen, render PSNR on the training view and the held-out
            view of its first task's first training transition (means as
            eval_psnr, eval_psnr_fg, eval_psnr_holdout);
          - the BC decode of every transition with its task's language
            tokens: bc_train_* / bc_holdout_*, and per task bc_t{t}_*;
          - the same decode with zero language (bc_zerolang_*): tasks share
            their first keyframe, so without language that transition is
            undecidable;
          - bc_score and bc_render_score, as make_replay_eval.
        Static int8 scales are calibrated once per kitchen, on its training
        view's rays. render_draws as make_replay_eval's. save_dir: each
        kitchen's training-view panel, k{kid}_render_{step:06d}.png."""
        from real_robot_nerf_actor_tpu_torch.data.replay import ReplaySource

        c, dev = self.cfg, self.device
        srcs = [ReplaySource(e["root"], e["n_demos"]) for e in entries]
        zero_lang = torch.zeros((1, c.model.lang_max_seq_len, c.model.lang_emb_dim),
                                device=dev)
        langs = [torch.as_tensor(e["lang"], dtype=torch.float32)[None].to(dev)
                 for e in entries]
        tasks = sorted({e["task"] for e in entries})
        kitchens = sorted({e["kitchen"] for e in entries})
        kitchen_entry = {e["kitchen"]: ei for ei, e in enumerate(entries)
                         if e["task"] == min(tasks)}
        transitions = []   # (entry, demo, k, cloud, want, trained)
        for ei, (e, src) in enumerate(zip(entries, srcs)):
            transitions += [(ei,) + t for t in self._stage_transitions(
                src, e["n_demos"], set(e.get("exclude_demos", ())))]
        nrc = c.model.num_rotation_classes

        def eval_fn(state: TrainState, step: int) -> Dict[str, float]:
            draws = render_draws(step) if render_draws is not None else None
            metrics: Dict[str, float] = {}
            ps, ps_fg, ps_h = [], [], []
            for kid in kitchens:
                ei = kitchen_entry[kid]
                src = srcs[ei]
                _, d0_, k0, cloud, _, _ = next(t for t in transitions if t[0] == ei and t[5])
                feat = self._policy_out(state, cloud, langs[ei])[3]
                rend = self._renderer_of(state)
                pose = torch.as_tensor(src.train_pose(0))[None].to(dev)
                focal = torch.tensor(src.focal, device=dev)
                self._calibrate(rend, feat, pose, focal, step)
                rgb, embed, depth = self._render(rend, feat, pose, focal, step, draws)
                gt = src.view(d0_, k0, 0)["rgb"]
                rgb_np = rgb.float().cpu().numpy()
                ps.append(psnr_np(rgb_np, gt))
                fg = gt.sum(-1) > 0.02
                if fg.any():
                    ps_fg.append(psnr_np(rgb_np[fg], gt[fg]))
                if src.has_holdout:
                    hpose = torch.as_tensor(src.holdout_pose)[None].to(dev)
                    hrgb = self._render(rend, feat, hpose, focal, step, draws)[0]
                    ps_h.append(psnr_np(hrgb.float().cpu().numpy(),
                                        src.holdout_view(d0_, k0)["rgb"]))
                if save_dir:
                    _save_panel(save_dir, f"k{kid}_render_{step:06d}.png", gt, rgb_np,
                                depth, embed, ps[-1])
            metrics["eval_psnr"] = float(np.mean(ps))
            if ps_fg:
                metrics["eval_psnr_fg"] = float(np.mean(ps_fg))
            if ps_h:
                metrics["eval_psnr_holdout"] = float(np.mean(ps_h))

            per_task = {t: _blank() for t in tasks}
            agg = {True: _blank(), False: _blank()}
            zl = _blank()
            for ei, d, k, cloud, want, trn in transitions:
                got = self._decode(state, cloud, langs[ei])
                _score(agg[trn], *got, want, nrc)
                if trn:
                    _score(per_task[entries[ei]["task"]], *got, want, nrc)
                    _score(zl, *self._decode(state, cloud, zero_lang), want, nrc)
            _emit(metrics, "bc_train", agg[True])
            _emit(metrics, "bc_holdout", agg[False])
            for t in tasks:
                _emit(metrics, f"bc_t{t}", per_task[t])
            _emit(metrics, "bc_zerolang", zl, with_rot_grip=False)
            metrics["bc_score"] = _bc_score(agg[True])
            metrics["bc_render_score"] = metrics["bc_score"] + 0.01 * float(
                metrics.get("eval_psnr_holdout", 0.0))
            return metrics

        return eval_fn

    def make_trainer(self, data: Optional[Iterator] = None,
                     eval_batch: Optional[Dict[str, torch.Tensor]] = None,
                     eval_fn: Optional[Callable] = None,
                     eval_save_dir: Optional[str] = None) -> Trainer:
        """The Trainer over `data` (synthetic batches without it). eval_fn
        defaults to render_eval on eval_batch (its panels to eval_save_dir)."""
        if eval_fn is None:
            def eval_fn(state, step):
                return self.render_eval(state, step, batch=eval_batch, save_dir=eval_save_dir)
        return Trainer(self.cfg.train, self.train_step, data or self.synthetic_data(),
                       self.init_state, eval_fn=eval_fn)


def _save_panel(save_dir: str, name: str, gt, rgb_np, depth, embed, psnr: float) -> None:
    """The gt / render / depth / embed panel of one eval render."""
    import os

    from real_robot_nerf_actor_tpu_torch.utils.visualize import save_render_panel

    os.makedirs(save_dir, exist_ok=True)
    save_render_panel(os.path.join(save_dir, name), gt, rgb_np,
                      depth=depth.float().cpu().numpy(), embed=embed.float().cpu().numpy(),
                      psnr=psnr)


def _blank() -> dict:
    return {"n": 0, "ex": 0, "near": 0, "rot1": 0, "grip": 0, "dists": []}


def _score(s: dict, got_t, got_rg, want, nrc: int) -> None:
    """Add one decoded transition to the tally `s`: exact voxel, within one
    voxel on every axis, voxel distance, rot bins within one (cyclic),
    grip."""
    s["n"] += 1
    s["ex"] += int((got_t == want["trans"]).all())
    s["near"] += int((np.abs(got_t - want["trans"]) <= 1).all())
    s["dists"].append(float(np.linalg.norm(got_t - want["trans"])))
    dbin = np.abs(got_rg[:3] - want["rot_grip"][:3])
    dbin = np.minimum(dbin, nrc - dbin)
    s["rot1"] += int((dbin <= 1).all())
    s["grip"] += int(got_rg[3] == want["rot_grip"][3])


def _emit(metrics: dict, prefix: str, s: dict, with_rot_grip: bool = True) -> None:
    if not s["n"]:
        return
    metrics[f"{prefix}_exact"] = s["ex"] / s["n"]
    metrics[f"{prefix}_within1"] = s["near"] / s["n"]
    metrics[f"{prefix}_dist"] = float(np.mean(s["dists"]))
    if with_rot_grip:
        metrics[f"{prefix}_rot1"] = s["rot1"] / s["n"]
        metrics[f"{prefix}_grip"] = s["grip"] / s["n"]


def _bc_score(s: dict) -> float:
    return (s["ex"] / s["n"] + s["near"] / s["n"]) / 2.0 - float(np.mean(s["dists"])) / 500.0


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


def _warm_start(tr: NerfActTrainer, ckpt_dir: str, donor_dir: str, policy_only: bool) -> None:
    """Seed a fresh run (no checkpoint in ckpt_dir yet) with the parameters
    of donor_dir's latest checkpoint, as a step-0 checkpoint. policy_only:
    every `policy.*` parameter of the donor (the field starts fresh);
    else every parameter whose name and shape the donor shares. Buffers
    (BatchNorm statistics) stay fresh, as the JAX script grafts params
    only."""
    from real_robot_nerf_actor_tpu_torch.train.trainer import CheckpointManager

    mgr = CheckpointManager(ckpt_dir)
    if mgr.latest_step() is not None:
        return
    donor = CheckpointManager(donor_dir).restore_raw_params()
    if donor is None:
        raise ValueError(f"no checkpoint in {donor_dir}")
    state = tr.init_state(torch.Generator().manual_seed(tr.cfg.train.seed))
    copied = fresh = 0
    with torch.no_grad():
        for name, p in state.module.named_parameters():
            if policy_only and not name.startswith("policy."):
                continue
            d = donor.get(name)
            if policy_only and d is None:
                raise ValueError(f"{donor_dir} lacks {name}")
            if d is not None and d.shape == p.shape:
                p.copy_(d)
                copied += 1
            else:
                fresh += 1
    mgr.save(0, state)
    print(f"[init] {copied} parameters from {donor_dir} ({fresh} fresh) in a step-0 checkpoint")


def _transitions_per_demo(entries) -> int:
    """The one transition count of every training demo (demo_cycle needs
    equal-length demos)."""
    from real_robot_nerf_actor_tpu_torch.data.replay import ReplaySource

    nt = set()
    for e in entries:
        src = ReplaySource(e["root"], e["n_demos"])
        nt |= {src.num_keyframes(d) - 1 for d in range(e["n_demos"])
               if d not in e["exclude_demos"]}
    if len(nt) != 1:
        raise SystemExit("--sample-mode demo_cycle needs equal-length demos; got "
                         f"transition counts {sorted(nt)}")
    return nt.pop()


def _warn_window(tcfg, batch_size: int, per_demo: int) -> None:
    window = tcfg.optim.accum_steps * batch_size
    if window != per_demo:
        print(f"[warn] demo_cycle: optimizer window {window} (accum_steps "
              f"{tcfg.optim.accum_steps} x batch {batch_size}) != {per_demo} transitions "
              "a demo; set peract.train.optim.accum_steps="
              f"{per_demo // max(1, batch_size)}")


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    """NeRF-Actor joint training (the counterpart of scripts/train_nerfact.py):
    on a multi-kitchen dataset with --multi-root (one language-conditioned
    checkpoint over every kitchen and task), on one recording with
    --data-root, else on the bundled synthetic scene. Configs are JSON (YAML
    where PyYAML is installed) with dot-path overrides."""
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
    ap.add_argument("--data-root", default=None,
                    help="recorded demos: calibration.json + {d}_xarm_position.txt + "
                         "real{d}/{pcd,rgb}{k}.*")
    ap.add_argument("--multi-root", default=None,
                    help="multi-kitchen multi-task dataset: manifest.json + "
                         "lang_embs.npz + k{i}_t{j}/")
    ap.add_argument("--n-demos", type=int, default=5)
    ap.add_argument("--exclude-demos", default="",
                    help="comma list of demo ids held out of training (their decode "
                         "is reported as bc_holdout_*)")
    ap.add_argument("--eval-save-dir", default=None,
                    help="write each eval's render panels (PNG) here")
    ap.add_argument("--sample-mode", default="uniform", choices=["uniform", "demo_cycle"])
    ap.add_argument("--init-policy-from", default=None,
                    help="checkpoint dir whose policy parameters seed a fresh run")
    ap.add_argument("--init-params-from", default=None,
                    help="checkpoint dir whose parameters of matching name and shape "
                         "seed a fresh run")
    args = ap.parse_args(argv)

    cfg = load_config(NerfActConfig, args.config, args.override)
    tcfg = cfg.peract.train
    if args.steps is not None:
        tcfg = dataclasses.replace(tcfg, num_steps=args.steps)
    tcfg = dataclasses.replace(tcfg, ckpt_dir=args.ckpt_dir or tcfg.ckpt_dir,
                               log_dir=args.log_dir or tcfg.log_dir)
    cfg = dataclasses.replace(cfg, peract=dataclasses.replace(cfg.peract, train=tcfg))
    tr = NerfActTrainer(cfg, device=args.device)
    for donor, policy_only in ((args.init_params_from, False),
                               (args.init_policy_from, True)):
        if donor:
            if not tcfg.ckpt_dir:
                raise SystemExit("--init-params-from / --init-policy-from need --ckpt-dir")
            _warm_start(tr, tcfg.ckpt_dir, donor, policy_only)
    exclude = tuple(int(x) for x in args.exclude_demos.split(",") if x)
    if args.multi_root:
        from real_robot_nerf_actor_tpu_torch.data.multitask import load_multitask_entries
        entries = load_multitask_entries(args.multi_root, exclude_demos=exclude)
        data = tr.multi_replay_data(entries, args.batch_size, sample_mode=args.sample_mode)
        if args.sample_mode == "demo_cycle":
            _warn_window(tcfg, args.batch_size, _transitions_per_demo(entries))
        trainer = tr.make_trainer(data, eval_fn=tr.make_multi_replay_eval(
            entries, save_dir=args.eval_save_dir))
    elif args.data_root:
        data = tr.replay_data(args.data_root, args.n_demos, args.batch_size,
                              exclude_demos=exclude, sample_mode=args.sample_mode)
        eval_batch = next(data)   # one fixed batch for the periodic render
        if args.sample_mode == "demo_cycle":
            # taking the eval batch used samples of the first demo's cycle:
            # realign to a cycle boundary, so that each accumulation window
            # holds one whole demo
            per_demo = _transitions_per_demo([{"root": args.data_root,
                                               "n_demos": args.n_demos,
                                               "exclude_demos": exclude}])
            residue = (-args.batch_size) % per_demo
            if residue % args.batch_size != 0:
                raise SystemExit(f"batch_size {args.batch_size} cannot realign to the "
                                 f"{per_demo}-transition demo cycle; pick a batch size "
                                 f"that divides {per_demo}")
            for _ in range(residue // args.batch_size):
                next(data)
            _warn_window(tcfg, args.batch_size, per_demo)
        trainer = tr.make_trainer(data, eval_fn=tr.make_replay_eval(
            args.data_root, args.n_demos, exclude_demos=exclude,
            save_dir=args.eval_save_dir, eval_batch=eval_batch))
    else:
        trainer = tr.make_trainer(tr.synthetic_data(batch_size=args.batch_size),
                                  eval_save_dir=args.eval_save_dir)
    return trainer.run(resume=not args.no_resume)


if __name__ == "__main__":
    main()
