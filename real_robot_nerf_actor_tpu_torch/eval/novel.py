"""Novel-view and distilled-feature evaluation of a FeatureNeRF checkpoint
(counterpart of `scripts/eval_novel.py`).

For each val scene: encode view 0, render view N/2 in full (tiles of 2048
rays) and score it against the image (PSNR, and SSIM of the grey images).
Where the scene carries depth, view (N/2 + 3) % N is rendered too, and
pixels of the first view are matched into it by the nearest rendered
embedding and scored against the depth reprojection (z-depth, K with
c = ((w - 1) / 2, (h - 1) / 2)), visible pixels only: the share within
`corr_radius` pixels, with its chance level. Each frame draws its samples
from a generator seeded per scene. With `--out` (evaluate's out_dir) each
scene's gt / render panel is written to novel_{si}.png (utils/visualize.py).

    python -m real_robot_nerf_actor_tpu_torch.eval.novel --data-root DIR \\
        --config configs/featurenerf.yaml --ckpt-dir CKPT
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from real_robot_nerf_actor_tpu_torch.eval.metrics import psnr_np, ssim_np
from real_robot_nerf_actor_tpu_torch.ops.rays import gen_rays

TILE = 2048


@torch.no_grad()
def render_view(tr, net, sc, enc, view: int, generator: Optional[torch.Generator] = None,
                tile: int = TILE):
    """Full frame of `view` of scene `sc` from the encoded source views:
    (rgb (H, W, 3), embed (H, W, D)) as numpy, fine level where there is
    one."""
    cfg = tr.cfg
    h, w = sc.images.shape[1:3]
    dev = tr.device
    pose = torch.as_tensor(np.asarray(sc.poses[view:view + 1], np.float32), device=dev)
    rays = gen_rays(pose, w, h, torch.tensor(float(sc.focal), device=dev), cfg.z_near,
                    cfg.z_far).reshape(-1, 8)
    rend = tr.renderer(net)
    rgb, emb = [], []
    for s in range(0, rays.shape[0], tile):
        out = rend.render_rays(enc, rays[s:s + tile], generator)
        f = out.get("fine", out["coarse"])
        rgb.append(f.rgb)
        emb.append(f.embed)
    return (torch.cat(rgb).reshape(h, w, 3).cpu().numpy(),
            torch.cat(emb).reshape(h, w, -1).cpu().numpy())


def depth_correspondence(emb_a, emb_b, sc, view_a: int, view_b: int, n_corr: int,
                         radius: float, rng: np.random.Generator) -> Optional[Dict]:
    """Match up to n_corr pixels of view_a (finite depth) into view_b by
    the cosine nearest rendered embedding; ground truth by unprojecting
    view_a's depth and reprojecting into view_b (occlusion: view_b's depth
    within 2%). None when fewer than 10 pixels are visible in both."""
    h, w = emb_a.shape[:2]
    cx, cy, f = (w - 1) / 2.0, (h - 1) / 2.0, sc.focal
    d_a, d_b = sc.depth[view_a], sc.depth[view_b]
    ys, xs = np.nonzero(np.isfinite(d_a))
    take = rng.choice(len(ys), size=min(n_corr, len(ys)), replace=False)
    ys, xs = ys[take], xs[take]
    dirs = np.stack([(xs - cx) / f, -(ys - cy) / f, -np.ones_like(xs, np.float64)], -1)
    t = d_a[ys, xs] / (-dirs[:, 2])
    pts = (dirs * t[:, None]) @ sc.poses[view_a][:3, :3].T + sc.poses[view_a][:3, 3]
    pc = (pts - sc.poses[view_b][:3, 3]) @ sc.poses[view_b][:3, :3]
    zb = -pc[:, 2]
    xb = pc[:, 0] / zb * f + cx
    yb = -pc[:, 1] / zb * f + cy
    xi, yi = np.round(xb).astype(int), np.round(yb).astype(int)
    inb = (zb > 0) & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    vis = inb.copy()
    vis[inb] &= np.abs(d_b[yi[inb], xi[inb]] - zb[inb]) < 0.02 * zb[inb]
    if vis.sum() < 10:
        return None
    qa = emb_a[ys[vis], xs[vis]]
    eb = emb_b.reshape(-1, emb_b.shape[-1])
    qa_n = qa / (np.linalg.norm(qa, axis=-1, keepdims=True) + 1e-8)
    eb_n = eb / (np.linalg.norm(eb, axis=-1, keepdims=True) + 1e-8)
    nn_idx = np.argmax(qa_n @ eb_n.T, axis=-1)
    derr = np.hypot(nn_idx // w - yb[vis], nn_idx % w - xb[vis])
    return {"corr_acc": float((derr <= radius).mean()), "corr_queries": int(vis.sum()),
            "corr_chance": (np.pi * radius ** 2) / (h * w),
            "corr_px_err_median": float(np.median(derr))}


def evaluate(tr, net, scenes, n_scenes: int = 3, n_corr: int = 200,
             corr_radius: float = 2.0, tile: int = TILE,
             out_dir: Optional[str] = None) -> Dict:
    """The eval of the module doc over the first n_scenes of `scenes`.
    Returns per-scene entries (psnr, ssim, frame_ms: the render time of
    each frame on the host clock, with a synchronise; corr_* with depth)
    and their means. out_dir: each scene's panel, novel_{si}.png."""
    results = {"scenes": []}
    psnrs, ssims, accs, chances = [], [], [], []
    rng = np.random.default_rng(0)
    dev = tr.device
    for si in range(min(n_scenes, len(scenes))):
        sc = scenes[si]
        nv = len(sc.images)
        src, tgt, tgt2 = 0, nv // 2, (nv // 2 + 3) % nv
        with torch.no_grad():
            enc = tr.encode(net, torch.as_tensor(sc.images[src:src + 1], device=dev),
                            torch.as_tensor(np.asarray(sc.poses[src:src + 1], np.float32),
                                            device=dev), float(sc.focal))
        gen = torch.Generator(device=dev).manual_seed(si)
        frame_ms = []

        def frame(view):
            t = time.perf_counter()
            out = render_view(tr, net, sc, enc, view, gen, tile)
            frame_ms.append((time.perf_counter() - t) * 1e3)
            return out

        pred, emb_a = frame(tgt)
        gt = sc.images[tgt]
        entry = {"psnr": psnr_np(pred, gt), "ssim": ssim_np(pred.mean(-1), gt.mean(-1))}
        psnrs.append(entry["psnr"])
        ssims.append(entry["ssim"])
        if out_dir:
            from real_robot_nerf_actor_tpu_torch.utils.visualize import save_render_panel
            os.makedirs(out_dir, exist_ok=True)
            save_render_panel(os.path.join(out_dir, f"novel_{si}.png"), gt, pred,
                              psnr=entry["psnr"])
        if n_corr > 0 and sc.depth is not None:
            _, emb_b = frame(tgt2)
            corr = depth_correspondence(emb_a, emb_b, sc, tgt, tgt2, n_corr, corr_radius, rng)
            if corr is not None:
                accs.append(corr["corr_acc"])
                chances.append(corr["corr_chance"])
                entry.update(corr)
        entry["frame_ms"] = frame_ms
        results["scenes"].append(entry)
    results.update(psnr_mean=float(np.mean(psnrs)), psnr_std=float(np.std(psnrs)),
                   ssim_mean=float(np.mean(ssims)))
    if accs:
        results.update(corr_acc_mean=float(np.mean(accs)), corr_chance=float(np.mean(chances)))
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Novel-view PSNR/SSIM and feature correspondence of a FeatureNeRF
    checkpoint on the val split of a scene directory."""
    from real_robot_nerf_actor_tpu_torch.data.scene_dataset import SceneDataset
    from real_robot_nerf_actor_tpu_torch.train.featurenerf import (
        FeatureNerfConfig, FeatureNerfTrainer)
    from real_robot_nerf_actor_tpu_torch.train.trainer import CheckpointManager
    from real_robot_nerf_actor_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--data-root", required=True, help="scene npz dir")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("-o", "--override", action="append", default=[])
    ap.add_argument("--n-scenes", type=int, default=3)
    ap.add_argument("--n-corr", type=int, default=200,
                    help="correspondence queries per scene (0 = off)")
    ap.add_argument("--corr-radius", type=float, default=2.0)
    ap.add_argument("--out", default=None, help="dir for the novel_{si}.png panels")
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    scenes = SceneDataset(args.data_root, split="val")
    tr = FeatureNerfTrainer(load_config(FeatureNerfConfig, args.config, args.override),
                            device=args.device)
    state = tr.init_state(torch.Generator().manual_seed(0))
    step = 0
    if args.ckpt_dir and CheckpointManager(args.ckpt_dir).restore(
            state, params_only=True) is not None:
        step = state.step
        print(f"restored step {step}")
    results = {"step": step, **evaluate(tr, state.module, scenes, args.n_scenes,
                                        args.n_corr, args.corr_radius, out_dir=args.out)}
    for si, entry in enumerate(results["scenes"]):
        print(f"scene {si}: {entry}")
    corr = (f"  corr@{args.corr_radius}px: {results['corr_acc_mean']:.3f}"
            f" (chance {results['corr_chance']:.4f})" if "corr_acc_mean" in results else "")
    print(f"novel-view PSNR: {results['psnr_mean']:.2f} +- {results['psnr_std']:.2f}  "
          f"SSIM: {results['ssim_mean']:.3f}{corr}")
    if args.out_json:
        os.makedirs(os.path.dirname(args.out_json) or ".", exist_ok=True)
        with open(args.out_json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
