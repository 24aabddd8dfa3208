"""Per-transition BC decode of a trained NeRF-Actor checkpoint (the
counterpart of scripts/analyze_bc.py, with its flags): for every (demo,
keyframe) transition of a recording, or of every (kitchen, task) of a
multi-kitchen dataset with its task's language tokens, the predicted and
the expected translation voxel, rotation bins and gripper, one line each.

    python -m real_robot_nerf_actor_tpu_torch.tools.analyze_bc \
        --config configs/nerfact.yaml --ckpt-dir CKPT (--data-root DIR | --multi-root DIR) \
        [--n-demos 5] [--device cuda]
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    from real_robot_nerf_actor_tpu_torch.data.replay import ReplaySource, pad_point_cloud
    from real_robot_nerf_actor_tpu_torch.ops import (
        choose_highest_action, discretize_action, voxelize)
    from real_robot_nerf_actor_tpu_torch.ops.geometry import point_to_voxel_index
    from real_robot_nerf_actor_tpu_torch.tools.eval_quality import restore_joint
    from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig
    from real_robot_nerf_actor_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("-o", "--override", action="append", default=[])
    ap.add_argument("--ckpt-dir", required=True)
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--data-root")
    group.add_argument("--multi-root",
                       help="multi-kitchen dataset root (manifest.json + lang_embs.npz): "
                            "every (kitchen, task, demo, keyframe) with its task's tokens")
    ap.add_argument("--n-demos", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(NerfActConfig, args.config, args.override)
    tr, state = restore_joint(cfg, args.ckpt_dir, args.device)
    dev = tr.device
    print(f"checkpoint step {int(state.step)}")
    c = cfg.peract
    zero_lang = torch.zeros((1, c.model.lang_max_seq_len, c.model.lang_emb_dim), device=dev)
    if args.multi_root:
        from real_robot_nerf_actor_tpu_torch.data.multitask import load_multitask_entries
        jobs = [(f"k{e['kitchen']}_t{e['task']} ", ReplaySource(e["root"], e["n_demos"]),
                 torch.as_tensor(np.asarray(e["lang"]), dtype=torch.float32,
                                 device=dev)[None])
                for e in load_multitask_entries(args.multi_root)]
    else:
        jobs = [("", ReplaySource(args.data_root, args.n_demos), zero_lang)]

    lines = []
    for prefix, src, lang in jobs:
        for d in range(len(src.demos)):
            demo = src.demos[d]
            nk = demo.num_keyframes
            xyz = torch.as_tensor(demo.xyz, device=dev)
            dd = discretize_action(xyz, torch.as_tensor(demo.rotation, device=dev),
                                   torch.as_tensor(demo.gripper_open, device=dev),
                                   torch.ones((nk,), device=dev), tr.bounds,
                                   c.model.voxel_size, c.rotation_resolution)
            ti = point_to_voxel_index(xyz, c.model.voxel_size, tr.bounds).cpu().numpy()
            rg = dd.rot_grip.cpu().numpy()
            for k in range(nk - 1):
                pts, cols, valid = pad_point_cloud(src.pointcloud(d, k),
                                                   c.voxelizer.max_num_coords)
                proprio = torch.as_tensor(np.concatenate(
                    [ti[k].astype(np.float32), rg[k].astype(np.float32)])[None], device=dev)
                with torch.inference_mode():
                    vox = voxelize(torch.as_tensor(pts, device=dev)[None],
                                   torch.as_tensor(cols, device=dev)[None], tr.bounds,
                                   c.voxelizer, valid=torch.as_tensor(valid, device=dev)[None])
                    out = state.module["policy"](vox, proprio, lang)
                    coords, rot_grip, _ = choose_highest_action(out[0], out[1], out[2],
                                                                c.rotation_resolution)
                got_t, got_rg = coords[0].cpu().numpy(), rot_grip[0].cpu().numpy()
                want_t, want_rg = ti[k + 1], rg[k + 1]
                dist = float(np.linalg.norm(got_t - want_t))
                mark = "OK " if dist == 0 else f"{dist:5.1f}"
                line = (f"{prefix}d{d} k{k}: pred {got_t.tolist()} want {want_t.tolist()}"
                        f" [{mark}] grip {int(got_rg[3])}/{int(want_rg[3])}"
                        f" rot {got_rg[:3].tolist()}/{want_rg[:3].tolist()}"
                        f" proprio_t {ti[k].tolist()} g{int(rg[k][3])}")
                print(line)
                lines.append(line)
    return lines


if __name__ == "__main__":
    main()
