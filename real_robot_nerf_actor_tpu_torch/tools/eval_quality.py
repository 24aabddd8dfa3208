"""Render quality and BC accuracy of a trained NeRF-Actor checkpoint (the
counterpart of scripts/eval_quality.py, with its flags).

  - the recorded ground-truth view (and the held-out view, where recorded)
    rendered from the checkpoint's voxel features through every serving
    variant of the script: the plain field in fp32 and bf16, the fused MLP
    kernels ("pallas_bf16", "pallas_int8"), occupancy sampling from the
    voxel channel, the field or both, ray culling and the static int8
    scales, the gather-fused kernel; PSNR against the view (whole and
    foreground) and max / mean |rgb gap| to the first variant's frame;
  - the BC argmax decode of every (demo, keyframe) transition, the held-out
    demos apart, and n_perturb SE(3)-shifted decodes of each.

    python -m real_robot_nerf_actor_tpu_torch.tools.eval_quality \
        --config configs/nerfact.yaml --ckpt-dir CKPT --data-root DATA \
        [--variants xla_fp32,occ_int8_cull16s] [--out quality.json] [--device cuda]

The config value that selects a Pallas kernel in the script ("pallas_*"
MLP backends) selects the Hopper kernel here. The checkpoint is the port's
(`ckpt_<step>.pt`), restored params-only. The render draws come from
generators seeded as the script's keys (7 for the frames, 1000 d + 10 k + p
for the perturbations); `frame_draws` and `perturb_draws` are the seams a
test replaces to feed other draws, `on_frame` the one that sees each
variant's frame.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

# (name, overrides) of every variant, in the script's order
VARIANTS = [
    ("xla_fp32", dict(compute_dtype="float32")),
    ("xla_bf16", dict(compute_dtype="bfloat16")),
    ("pallas_bf16", dict(compute_dtype="bfloat16", mlp_backend="pallas_bf16")),
    ("pallas_int8", dict(compute_dtype="bfloat16", mlp_backend="pallas_int8")),
    ("occ_bf16", dict(compute_dtype="bfloat16", mlp_backend="pallas_bf16",
                      sampling_mode="occupancy")),
    ("occ_int8_compact", dict(compute_dtype="bfloat16", mlp_backend="pallas_int8",
                              sampling_mode="occupancy", n_coarse=24, n_fine=16,
                              n_fine_depth=0)),
    ("occ_tighten_int8", dict(compute_dtype="bfloat16", mlp_backend="pallas_int8",
                              sampling_mode="occupancy", occ_probes=0, n_coarse=24,
                              n_fine=16, n_fine_depth=0)),
    ("occfield_bf16", dict(compute_dtype="bfloat16", mlp_backend="pallas_bf16",
                           sampling_mode="occupancy", occ_source="field")),
    ("occfield_int8_compact", dict(compute_dtype="bfloat16", mlp_backend="pallas_int8",
                                   sampling_mode="occupancy", occ_source="field",
                                   n_coarse=24, n_fine=16, n_fine_depth=0)),
    ("occauto_xla_bf16", dict(compute_dtype="bfloat16", sampling_mode="occupancy",
                              occ_source="auto", n_coarse=24, n_fine=16, n_fine_depth=0)),
    ("occfield_xla_bf16", dict(compute_dtype="bfloat16", sampling_mode="occupancy",
                               occ_source="field", n_coarse=24, n_fine=16, n_fine_depth=0)),
    ("occvoxel_xla_bf16", dict(compute_dtype="bfloat16", sampling_mode="occupancy",
                               occ_source="voxel", n_coarse=24, n_fine=16, n_fine_depth=0)),
    ("occauto_int8_compact", dict(compute_dtype="bfloat16", mlp_backend="pallas_int8",
                                  sampling_mode="occupancy", occ_source="auto",
                                  n_coarse=24, n_fine=16, n_fine_depth=0)),
    ("occ_int8_cull24", dict(compute_dtype="bfloat16", mlp_backend="pallas_int8",
                             sampling_mode="occupancy", occ_source="auto", n_coarse=24,
                             n_fine=16, n_fine_depth=0, cull=True)),
    ("occ_int8_cull16", dict(compute_dtype="bfloat16", mlp_backend="pallas_int8",
                             sampling_mode="occupancy", occ_source="auto", n_coarse=16,
                             n_fine=8, n_fine_depth=0, cull=True)),
    ("occ_int8_cull12", dict(compute_dtype="bfloat16", mlp_backend="pallas_int8",
                             sampling_mode="occupancy", occ_source="auto", n_coarse=12,
                             n_fine=6, n_fine_depth=0, cull=True)),
    ("occ_int8_cull16s", dict(compute_dtype="bfloat16", mlp_backend="pallas_int8",
                              sampling_mode="occupancy", occ_source="auto", n_coarse=16,
                              n_fine=8, n_fine_depth=0, cull=True, static_act=True)),
    ("occ_int8_cull16sgf", dict(compute_dtype="bfloat16", mlp_backend="pallas_int8",
                                sampling_mode="occupancy", occ_source="auto", n_coarse=16,
                                n_fine=8, n_fine_depth=0, cull=True, static_act=True,
                                gather_fused=True)),
]
FIELD_KEYS = ("compute_dtype", "mlp_backend", "int8_static_act", "gather_fused_mlp")


def variant_config(renderer_cfg, overrides: dict):
    """The RendererConfig of one variant (the script's `variant`)."""
    kw = dict(overrides)
    kw["use_ray_plan"] = kw.pop("cull", False)
    if kw.pop("static_act", False):
        kw["int8_static_act"] = True
    if kw.pop("gather_fused", False):
        kw["gather_fused_mlp"] = True
    field_kw = {k: v for k, v in kw.items() if k in FIELD_KEYS}
    rend_kw = {k: v for k, v in kw.items() if k not in field_kw}
    return dataclasses.replace(renderer_cfg,
                               field=dataclasses.replace(renderer_cfg.field, **field_kw),
                               **rend_kw)


def frame_draws(name: str, rend, plan, pose):
    """render_image's draws for variant `name` from `pose` (None: from the
    generator seeded 7)."""
    return None


def on_frame(name: str, rend, frame: np.ndarray) -> None:
    """Called with each variant's renderer and its frame of the recorded
    view, after that variant's renders (a caller's seam: launch counts, the
    frames themselves)."""


def perturb_draws(d: int, k: int, p: int) -> torch.Tensor:
    """The SE(3) shift's uniforms in [-1, 1) of perturbation p of (d, k)."""
    g = torch.Generator().manual_seed(1000 * d + 10 * k + p)
    return torch.rand((3,), generator=g) * 2.0 - 1.0


class Acc:
    """Tally of decoded transitions (the script's accuracies)."""

    def __init__(self):
        self.n = self.match = self.rot = self.rot1 = self.grip = self.near = 0
        self.dists = []

    def add(self, got_t, got_rg, want_t, want_rg, nrc: int):
        self.n += 1
        self.dists.append(float(np.linalg.norm(got_t - want_t)))
        self.match += int((got_t == want_t).all())
        self.near += int((np.abs(got_t - want_t) <= 1).all())
        self.rot += int((got_rg[:3] == want_rg[:3]).all())
        dbin = np.abs(got_rg[:3] - want_rg[:3])
        dbin = np.minimum(dbin, nrc - dbin)
        self.rot1 += int((dbin <= 1).all())
        self.grip += int(got_rg[3] == want_rg[3])

    def summary(self) -> dict:
        if self.n == 0:
            return {}
        return {"transitions": self.n,
                "trans_exact_match": round(self.match / self.n, 4),
                "trans_within_1vox": round(self.near / self.n, 4),
                "trans_mean_voxel_dist": round(float(np.mean(self.dists)), 3),
                "rot_exact_match": round(self.rot / self.n, 4),
                "rot_within_1bin": round(self.rot1 / self.n, 4),
                "grip_match": round(self.grip / self.n, 4)}


def restore_joint(cfg, ckpt_dir: str, device):
    """(NerfActTrainer, its state with the latest checkpoint's parameters),
    restored params-only; raises SystemExit without a checkpoint."""
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActTrainer
    from real_robot_nerf_actor_tpu_torch.train.trainer import CheckpointManager

    tr = NerfActTrainer(cfg, device=device)
    state = tr.init_state(torch.Generator().manual_seed(0))
    restored = CheckpointManager(ckpt_dir).restore(state, params_only=True)
    if restored is None:
        raise SystemExit(f"no checkpoint in {ckpt_dir}")
    return tr, restored


def cloud_of(tr, src, d: int, k: int, points=None):
    """(points, colors, valid, proprio) of transition (d, k) on the
    trainer's device, each (1, ...): the proprio as the replay step makes
    it (keyframe k's voxel index and discretized rot_grip)."""
    from real_robot_nerf_actor_tpu_torch.data.replay import pad_point_cloud
    from real_robot_nerf_actor_tpu_torch.ops import discretize_action
    from real_robot_nerf_actor_tpu_torch.ops.geometry import point_to_voxel_index

    c, dev = tr.cfg, tr.device
    demo = src.demos[d]
    pts, cols, valid = pad_point_cloud(src.pointcloud(d, k), c.voxelizer.max_num_coords)
    xyz = torch.as_tensor(demo.xyz[k:k + 1], device=dev)
    dd = discretize_action(xyz, torch.as_tensor(demo.rotation[k:k + 1], device=dev),
                           torch.as_tensor(demo.gripper_open[k:k + 1], device=dev),
                           torch.ones((1,), device=dev), tr.bounds, c.model.voxel_size,
                           c.rotation_resolution)
    trans = point_to_voxel_index(xyz, c.model.voxel_size, tr.bounds)
    proprio = torch.cat([trans.float(), dd.rot_grip.float()], dim=-1)
    pts = torch.as_tensor(pts if points is None else points, device=dev)
    return (pts.reshape(1, -1, 3), torch.as_tensor(cols, device=dev)[None],
            torch.as_tensor(valid, device=dev)[None], proprio)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from real_robot_nerf_actor_tpu_torch.data.replay import ReplaySource
    from real_robot_nerf_actor_tpu_torch.eval.metrics import psnr_np
    from real_robot_nerf_actor_tpu_torch.ops import (
        apply_se3_augmentation, choose_highest_action, discretize_action, voxelize)
    from real_robot_nerf_actor_tpu_torch.render import NeuralRenderer
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig
    from real_robot_nerf_actor_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("-o", "--override", action="append", default=[])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--n-demos", type=int, default=5)
    ap.add_argument("--holdout-demos", default="",
                    help="comma list of demo ids the checkpoint was not trained on")
    ap.add_argument("--n-perturb", type=int, default=2,
                    help="SE(3)-perturbed decodes per transition (0 = off)")
    ap.add_argument("--lang-npz", default=None,
                    help="lang_embs.npz of a multi-kitchen dataset: decode with this "
                         "task's language tokens instead of zeros")
    ap.add_argument("--task-index", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--panels-dir", default=None, help="save per-variant render panels here")
    ap.add_argument("--variants", default=None, help="comma list to restrict the variants")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(NerfActConfig, args.config, args.override)
    tr, state = restore_joint(cfg, args.ckpt_dir, args.device)
    dev = tr.device
    print(f"[quality] checkpoint step {int(state.step)}")
    src = ReplaySource(args.data_root, args.n_demos)
    c = cfg.peract
    if args.lang_npz:
        lang = torch.as_tensor(np.load(args.lang_npz)["embs"][args.task_index],
                               dtype=torch.float32, device=dev)[None]
        print(f"[quality] lang: {args.lang_npz}[{args.task_index}] {tuple(lang.shape)}")
    else:
        lang = torch.zeros((1, c.model.lang_max_seq_len, c.model.lang_emb_dim), device=dev)

    cloud = cloud_of(tr, src, 0, 0)
    with torch.inference_mode():
        vox = voxelize(*cloud[:2], tr.bounds, c.voxelizer, valid=cloud[2])
        voxel_feat = state.module["policy"](vox, cloud[3], lang)[3]
    gt = src.view(0, 0)["rgb"]
    fg = gt.sum(-1) > 0.02
    pose = torch.as_tensor(src.gt_pose, device=dev)[None]
    focal = torch.tensor(src.focal, device=dev)
    occ_channel = vox[0, ..., -1]
    hv = src.holdout_view(0, 0) if src.has_holdout else None
    hpose = torch.as_tensor(src.holdout_pose, device=dev)[None] if hv is not None else None

    variants = VARIANTS
    if args.variants:
        keep = set(args.variants.split(","))
        variants = [v for v in variants if v[0] in keep]
    field_sd = state.module["nerf"].state_dict()
    results = {"step": int(state.step)}
    ref_img = None
    for name, overrides in variants:
        rend = NeuralRenderer(variant_config(cfg.renderer, overrides), device=dev)
        rend.load_field(field_sd)
        rc = rend.cfg
        do_cull = rc.sampling_mode == "occupancy" and rc.use_ray_plan
        with torch.inference_mode():
            occ = rend.prepare(voxel_feat[:1], occupancy=occ_channel,
                               generator=torch.Generator(device=dev).manual_seed(0))
            if rc.field.int8_static_act:
                rend.calibrate_int8_act(voxel_feat[:1], rend.frame_rays(pose, focal),
                                        generator=torch.Generator(device=dev).manual_seed(0))
            entry = {}
            views = [("", pose, gt, fg)]
            if hv is not None:
                views.append(("_holdout", hpose, hv["rgb"], hv["rgb"].sum(-1) > 0.02))
            for suffix, p, want, mask in views:
                plan = rend.plan_rays(occ, p, focal) if do_cull and occ is not None else None
                rgb, embed, depth = rend.render_image(
                    voxel_feat[:1], p, focal, torch.Generator(device=dev).manual_seed(7),
                    occ=occ, plan=plan, draws=frame_draws(name, rend, plan, p))
                img = rgb.float().cpu().numpy()
                entry["psnr" + suffix] = psnr_np(img, want)
                entry["psnr" + suffix + "_fg"] = (psnr_np(img[mask], want[mask])
                                                  if mask.any() else 0.0)
                if not suffix:
                    frame, frame_embed, frame_depth = img, embed, depth
                    if do_cull and plan is not None:
                        entry["cull_active_frac"] = plan.n_active / plan.n_total
        if ref_img is None:
            ref_img = frame
        else:
            d = np.abs(frame - ref_img)
            entry["max_drgb_vs_fp32"] = float(d.max())
            entry["mean_drgb_vs_fp32"] = float(d.mean())
        results[name] = {k: round(float(x), 4) for k, x in entry.items()}
        print(f"[quality] {name}: {results[name]}")
        on_frame(name, rend, frame)
        if args.panels_dir:
            from real_robot_nerf_actor_tpu_torch.utils.visualize import save_render_panel
            os.makedirs(args.panels_dir, exist_ok=True)
            save_render_panel(os.path.join(args.panels_dir, f"quality_{name}.png"), gt, frame,
                              depth=frame_depth.float().cpu().numpy(),
                              embed=frame_embed.float().cpu().numpy(), psnr=entry["psnr"])

    # ------------------------------------------------------- BC decoding
    holdout = {int(x) for x in args.holdout_demos.split(",") if x}
    acc_train, acc_hold, acc_pert = Acc(), Acc(), Acc()
    nrc = c.model.num_rotation_classes
    ranges = torch.as_tensor(c.trans_aug_range, dtype=torch.float32, device=dev)

    def decode(pts, cols, valid, proprio):
        with torch.inference_mode():
            v = voxelize(pts, cols, tr.bounds, c.voxelizer, valid=valid)
            o = state.module["policy"](v, proprio, lang)
            coords, rot_grip, _ = choose_highest_action(o[0], o[1], o[2],
                                                        c.rotation_resolution)
        return coords[0].cpu().numpy(), rot_grip[0].cpu().numpy()

    for d in range(args.n_demos):
        demo = src.demos[d]
        for k in range(src.num_keyframes(d) - 1):
            cl = cloud_of(tr, src, d, k)
            xyz1, rot1, g1 = src.pose(d, k + 1)
            want = discretize_action(
                torch.as_tensor(xyz1, device=dev)[None], torch.as_tensor(rot1, device=dev)[None],
                torch.tensor([float(g1)], device=dev), torch.ones((1,), device=dev),
                tr.bounds, c.model.voxel_size, c.rotation_resolution)
            want_t, want_rg = want.trans[0].cpu().numpy(), want.rot_grip[0].cpu().numpy()
            (acc_hold if d in holdout else acc_train).add(*decode(*cl), want_t, want_rg, nrc)
            kf = torch.as_tensor(np.stack([demo.xyz[k], demo.xyz[k + 1]]), device=dev)
            for p in range(args.n_perturb):
                aug = apply_se3_augmentation(cl[0], kf, tr.bounds, ranges,
                                             c.model.voxel_size,
                                             u=perturb_draws(d, k, p).to(dev))
                proprio = torch.cat([aug.action_trans[0:1].float(), cl[3][:, 3:]], dim=-1)
                got = decode(aug.pcd, cl[1], cl[2], proprio)
                acc_pert.add(*got, aug.action_trans[1].cpu().numpy(), want_rg, nrc)
    results["bc"] = acc_train.summary()
    print("[quality] BC decode (train demos):", results["bc"])
    if acc_hold.n:
        results["bc_holdout_demo"] = acc_hold.summary()
        print("[quality] BC decode (held-out demos):", results["bc_holdout_demo"])
    if acc_pert.n:
        results["bc_se3_perturbed"] = acc_pert.summary()
        print("[quality] BC decode (SE3-perturbed):", results["bc_se3_perturbed"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[quality] wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
