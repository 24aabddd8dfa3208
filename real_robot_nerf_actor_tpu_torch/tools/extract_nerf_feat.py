"""NeRF -> feature point cloud of a trained NeRF-Actor checkpoint (the
counterpart of scripts/extract_nerf_feat.py, with its flags): the policy's
voxel features of a synthetic observation, the field's radiance at
stratified samples of every ray of its view, sigma-thresholded by
`eval.extract.extract_nerf_pointcloud` into a 50-70k point feature cloud,
saved as npz.

    python -m real_robot_nerf_actor_tpu_torch.tools.extract_nerf_feat \
        --ckpt-dir CKPT [--out nerf_feat.npz] [--target-min 50000] \
        [--target-max 70000] [--config FILE] [-o key=value] [--device cuda]

NerfActConfig's defaults as the script's, unless --config / -o say
otherwise. Without a checkpoint the weights are the seed's. The samples'
draws come from a generator seeded 2 (the script's key); `coarse_draws` is
the seam a test replaces to feed other draws.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def coarse_draws(shape, device) -> torch.Tensor:
    """The stratified samples' uniforms, (rays, n_coarse)."""
    return torch.rand(shape, generator=torch.Generator().manual_seed(2)).to(device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from real_robot_nerf_actor_tpu_torch.eval.extract import extract_nerf_pointcloud
    from real_robot_nerf_actor_tpu_torch.ops import gen_rays, voxelize
    from real_robot_nerf_actor_tpu_torch.ops.sampling import sample_coarse
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig, NerfActTrainer
    from real_robot_nerf_actor_tpu_torch.train.trainer import CheckpointManager
    from real_robot_nerf_actor_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", default="nerf_feat.npz")
    ap.add_argument("--target-min", type=int, default=50000)
    ap.add_argument("--target-max", type=int, default=70000)
    ap.add_argument("--config", default=None)
    ap.add_argument("-o", "--override", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(NerfActConfig, args.config, args.override)
    tr = NerfActTrainer(cfg, device=args.device)
    state = tr.init_state(torch.Generator().manual_seed(0))
    restored = CheckpointManager(args.ckpt_dir).restore(state, params_only=True)
    if restored is not None:
        state = restored
        print(f"restored step {int(state.step)}")

    batch = next(tr.synthetic_data(batch_size=1))
    rc = cfg.renderer
    with torch.inference_mode():
        vox = voxelize(batch["points"], batch["colors"], tr.bounds, cfg.peract.voxelizer,
                       valid=batch["valid"])
        voxel_feat = state.module["policy"](vox, batch["proprio"], batch["lang"])[3]
        rays = gen_rays(batch["gt_pose"][:1], rc.image_width, rc.image_height,
                        batch["focal"][0], rc.z_near, rc.z_far).reshape(-1, 8)
        z = sample_coarse(rays, rc.n_coarse,
                          u=coarse_draws((rays.shape[0], rc.n_coarse), rays.device))
        pts = rays[:, None, :3] + z[..., None] * rays[:, None, 3:6]
        dirs = rays[:, None, 3:6].expand(pts.shape)
        rkd = pts.shape[0] * pts.shape[1]
        fo = state.module["nerf"](voxel_feat[:1], pts.reshape(1, rkd, 3),
                                  dirs.reshape(1, rkd, 3))
    res = extract_nerf_pointcloud(
        pts.reshape(-1, 3).cpu().numpy(), fo["rgb"].float().reshape(-1, 3).cpu().numpy(),
        fo["sigma"].float().reshape(-1).cpu().numpy(),
        fo["embed"].float().reshape(rkd, -1).cpu().numpy(),
        target_min=args.target_min, target_max=args.target_max)
    np.savez_compressed(args.out, **res)
    print(f"saved {res['points'].shape[0]} points -> {args.out} "
          f"(sigma thr {float(res['threshold']):.4f})")
    return res


if __name__ == "__main__":
    main()
