"""Data generation (the counterpart of scripts/gen_data.py, with its flags and
files): expert demonstrations and multi-view NeRF scenes of the MuJoCo xArm
suite, and recorded-format kitchens.

    python -m real_robot_nerf_actor_tpu_torch.tools.gen_data demos --task lift --out DIR
    python -m real_robot_nerf_actor_tpu_torch.tools.gen_data nerf --n 8 --out DIR
    python -m real_robot_nerf_actor_tpu_torch.tools.gen_data episodes --obs-mode pointcloud --out DIR
    python -m real_robot_nerf_actor_tpu_torch.tools.gen_data kitchen --out DIR
    python -m real_robot_nerf_actor_tpu_torch.tools.gen_data multikitchen --out DIR

`demos` writes traj_<i>.npz (observations, actions, rewards, ee_positions,
gripper_open, success) of the scripted expert's successful state episodes;
`nerf` writes scene_<i:04d>.npz orbit scenes with depth; `episodes` (the
port's own mode) writes the expert's successful episodes in --obs-mode as
ep_<i>.npz through `data/episodes.save_trajectory`, the files
`EpisodeDataset` reads. These three need `mujoco` and `gymnasium`. `kitchen` and `multikitchen` run `data/kitchen.py`;
`multikitchen` encodes its task instructions with the text tower on
`--device` (the card unless `--device cpu`).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["demos", "nerf", "kitchen", "multikitchen", "episodes"],
                    help="demos: expert keyframe trajectories; "
                         "nerf: multi-view scene npz files; "
                         "kitchen: recorded real-robot-format demos "
                         "(ply + rgb png + xarm txt + calibration); "
                         "multikitchen: kitchens x language-conditioned "
                         "tasks grid + manifest + CLIP lang embeddings; "
                         "episodes: expert episodes for EpisodeDataset")
    ap.add_argument("--kitchens", type=int, default=2)
    ap.add_argument("--tasks", type=int, default=3)
    ap.add_argument("--task", default="lift")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=5)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--image-size", type=int, default=48)
    ap.add_argument("--image-hw", type=int, nargs=2, default=(60, 80),
                    help="kitchen GT view size (reference: 60 80)")
    ap.add_argument("--focal", type=float, default=76.18)
    ap.add_argument("--keyframes", type=int, default=5)
    ap.add_argument("--d-embed", type=int, default=512)
    ap.add_argument("--no-embeds", action="store_true")
    ap.add_argument("--train-views", type=int, default=1,
                    help="extra GT training cameras (multi-view GT "
                         "supervision; holdout camera always excluded)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs-mode", default="pointcloud",
                    choices=["state", "image", "depth", "pointcloud"],
                    help="episodes: the env's observation mode")
    ap.add_argument("--episode-length", type=int, default=40, help="episodes: steps at most")
    ap.add_argument("--device", default="cuda",
                    help="where multikitchen runs the text tower")
    args = ap.parse_args(argv)

    import numpy as np
    os.makedirs(args.out, exist_ok=True)

    if args.mode == "multikitchen":
        from real_robot_nerf_actor_tpu_torch.data.kitchen import write_multi_kitchen_dataset
        m = write_multi_kitchen_dataset(
            args.out, n_kitchens=args.kitchens, n_tasks=args.tasks,
            n_demos=args.n, seed=args.seed, device=args.device,
            image_hw=tuple(args.image_hw), focal=args.focal, d_embed=args.d_embed,
            write_embeds=not args.no_embeds, n_train_views=args.train_views)
        print(f"saved {m['n_kitchens']} kitchens x {m['n_tasks']} tasks x "
              f"{m['n_demos']} demos -> {args.out}")
    elif args.mode == "kitchen":
        from real_robot_nerf_actor_tpu_torch.data.kitchen import write_kitchen_demos
        write_kitchen_demos(
            args.out, n_demos=args.n, n_keyframes=args.keyframes,
            image_hw=tuple(args.image_hw), focal=args.focal, seed=args.seed,
            d_embed=args.d_embed, write_embeds=not args.no_embeds,
            n_train_views=args.train_views)
        print(f"saved {args.n} kitchen demos x {args.keyframes} keyframes -> {args.out}")
    elif args.mode == "demos":
        from real_robot_nerf_actor_tpu_torch.data.demos import (
            KeyframeBuffer, generate_demonstrations)
        trajs = generate_demonstrations(args.task, n_demos=args.n, obs_mode="state",
                                        episode_length=80, seed=args.seed)
        buf = KeyframeBuffer()
        for i, tr in enumerate(trajs):
            buf.add_trajectory(tr)
            np.savez_compressed(
                os.path.join(args.out, f"traj_{i}.npz"),
                observations=np.stack(tr.observations),
                actions=np.stack(tr.actions),
                rewards=np.asarray(tr.rewards),
                ee_positions=np.stack(tr.ee_positions),
                gripper_open=np.asarray(tr.gripper_open),
                success=tr.success)
        print(f"saved {len(trajs)} trajectories ({len(buf)} keyframes) -> {args.out}")
    elif args.mode == "episodes":
        from real_robot_nerf_actor_tpu_torch.data.demos import generate_demonstrations
        from real_robot_nerf_actor_tpu_torch.data.episodes import save_trajectory
        trajs = generate_demonstrations(args.task, n_demos=args.n, obs_mode=args.obs_mode,
                                        image_size=args.image_size,
                                        episode_length=args.episode_length, seed=args.seed)
        for i, tr in enumerate(trajs):
            save_trajectory(os.path.join(args.out, f"ep_{i}.npz"), tr)
        print(f"saved {len(trajs)} {args.obs_mode} episodes -> {args.out}")
    else:
        from real_robot_nerf_actor_tpu_torch.data.demos import generate_nerf_scene
        from real_robot_nerf_actor_tpu_torch.data.scene_dataset import save_scene
        for i in range(args.n):
            sc = generate_nerf_scene(args.task, n_views=args.views,
                                     image_size=args.image_size, seed=args.seed + i)
            save_scene(os.path.join(args.out, f"scene_{i:04d}.npz"), sc)
        print(f"saved {args.n} scenes x {args.views} views -> {args.out}")


def npz_digest(path: str) -> str:
    """sha256 of an npz's arrays (names, dtypes, shapes and bytes, in name
    order): the file's own bytes also hold each zip entry's write time."""
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    with np.load(path) as z:
        for k in sorted(z.files):
            a = np.ascontiguousarray(z[k])
            h.update(f"{k}|{a.dtype.str}|{a.shape}|".encode())
            h.update(a.tobytes())
    return h.hexdigest()


if __name__ == "__main__":
    main()
