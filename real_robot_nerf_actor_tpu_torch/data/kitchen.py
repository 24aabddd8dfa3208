"""Kitchen-demo dataset writer (the port's counterpart of the JAX package's
`data/kitchen.py`): demos recorded in the on-disk layout that
`data/replay.ReplaySource` reads, without hardware.

    out/
      calibration.json            # cam2base (OpenCV), gt_pose (OpenGL),
                                  # holdout_pose, focal, image_hw, embed_dim
      {d}_xarm_position.txt       # keyframe poses, mm + True/False gripper
      real{d}/pcd{k}.ply          # per-keyframe cloud, camera frame + rgb
      real{d}/rgb{k}.png          # ground-truth view
      real{d}/holdout{k}.png      # a second view training never sees
      real{d}/embed{k}.npy        # optional teacher features (H, W, D) f16
      real{d}/depth{k}.npy        # optional depth (H, W) f16

The 'sensor' is the analytic synthetic kitchen raytraced exactly
(`data/synthetic.raytrace_views`). Clouds are stored in the OpenCV camera
frame and moved back by cam2base when loaded (`data/replay.load_rgb_pcd`).
Every file equals the JAX package's for the same arguments except
lang_embs.npz: its text tower draws random weights from a torch.Generator,
not from a JAX key (pass `state_dict` to `encode_task_instructions` for
given weights). PNGs go through the port's codec (`data/png.py`): the
pixels equal those PIL writes, the bytes need not.
"""
from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from real_robot_nerf_actor_tpu_torch.data.ply import write_ply
from real_robot_nerf_actor_tpu_torch.data.png import write_png
from real_robot_nerf_actor_tpu_torch.data.synthetic import (
    GRIPPER_COLOR, GRIPPER_HALF, TASK_INSTRUCTIONS, _look_at, add_gripper_blob,
    make_synthetic_demo, make_synthetic_scene, make_task_demo, raytrace_views,
    teacher_embed)

GL2CV = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float64)


def _to_png(rgb: np.ndarray) -> np.ndarray:
    return np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)


def write_kitchen_demos(out: str, n_demos: int = 5, n_keyframes: int = 5,
                        image_hw: Tuple[int, int] = (60, 80), focal: float = 76.18,
                        seed: int = 0, d_embed: int = 512, write_embeds: bool = True,
                        write_depth: bool = True, n_points: int = 60000,
                        camera_eye: Optional[Tuple[float, float, float]] = None,
                        n_train_views: int = 1, task: Optional[int] = None,
                        scene_seed: Optional[int] = None) -> dict:
    """Write a kitchen of `n_demos` demos; returns the calibration dict.

    task: record demos of `make_task_demo`'s task (5 keyframes each,
    whatever n_keyframes says) instead of the grasp demo. scene_seed
    separates the scene (shared by every task of one kitchen) from the
    demos' jitter seed; the gripper blob's and the home pose's seeds then
    do not depend on the task, so keyframe 0 is the same across the tasks
    of one (kitchen, demo) and only the language tells them apart.
    """
    h, w = image_hw
    os.makedirs(out, exist_ok=True)
    sseed = seed if scene_seed is None else scene_seed
    scene = make_synthetic_scene(seed=sseed, n_points=n_points,
                                 table_color=(0.45, 0.32, 0.18))
    center = np.array([0.35, 0.2, 0.1], np.float64)
    # the default eye is 1.45 m from the scene centre: every surface lies in
    # the renderer's [z_near = 1.2, z_far = 4.0] band
    eye = (np.asarray(camera_eye, np.float64) if camera_eye is not None
           else center + np.array([0.9, -0.75, 0.85]))
    pose_gl = _look_at(eye.astype(np.float32), center.astype(np.float32))
    cam2base_cv = pose_gl.astype(np.float64) @ GL2CV
    # the held-out camera: rotated ~35 degrees about the centre, same range
    eye_h = center + np.array([-0.35, -1.05, 0.9])
    holdout_pose = _look_at(eye_h.astype(np.float32), center.astype(np.float32))
    # extra training cameras (n_train_views > 1), distinct from the holdout
    extra_eyes = [center + np.array([1.15, 0.25, 0.8]),
                  center + np.array([0.35, -1.1, 0.75]),
                  center + np.array([-0.9, -0.6, 0.95])]
    train_poses = [pose_gl] + [
        _look_at(e.astype(np.float32), center.astype(np.float32))
        for e in extra_eyes[:max(0, n_train_views - 1)]]

    calib = {
        "cam2base": cam2base_cv.tolist(),
        "gt_pose": pose_gl.astype(np.float64).tolist(),
        "holdout_pose": holdout_pose.astype(np.float64).tolist(),
        "focal": float(focal),
        "image_hw": [int(h), int(w)],
        "embed_dim": int(d_embed) if write_embeds else 0,
    }
    if n_train_views > 1:
        calib["train_poses"] = [p.astype(np.float64).tolist() for p in train_poses]
    with open(os.path.join(out, "calibration.json"), "w") as f:
        json.dump(calib, f, indent=1)

    r_inv = np.linalg.inv(cam2base_cv)
    for d in range(n_demos):
        if task is None:
            demo = make_synthetic_demo(scene, seed=seed + 7 * d + 1, n_keyframes=n_keyframes)
        else:
            demo = make_task_demo(scene, task, seed=seed + 7 * d + 1,
                                  home_seed=sseed * 31 + d)
        _write_xarm_position_file(os.path.join(out, f"{d}_xarm_position.txt"), demo)
        ddir = os.path.join(out, f"real{d}")
        os.makedirs(ddir, exist_ok=True)
        for k in range(demo.num_keyframes):
            # the blob's seed does not depend on the task: the shared home
            # keyframe's cloud is the same across tasks
            pts, cols = add_gripper_blob(scene, demo.xyz[k], seed=sseed * 17 + 100 * d + k)
            p_cam = pts @ r_inv[:3, :3].T.astype(np.float32) + r_inv[:3, 3].astype(np.float32)
            write_ply(os.path.join(ddir, f"pcd{k}.ply"), p_cam, (cols + 1.0) / 2.0)
            gripper = (demo.xyz[k][None], GRIPPER_HALF[None], GRIPPER_COLOR[None])
            for v, pose_v in enumerate(train_poses[:max(1, n_train_views)]):
                sfx = "" if v == 0 else f"_v{v}"
                rgb, depth, xyz, mask = raytrace_views(scene, pose_v[None], h, w, focal,
                                                       extra_boxes=gripper)
                write_png(os.path.join(ddir, f"rgb{k}{sfx}.png"), _to_png(rgb[0]))
                if write_depth:
                    np.save(os.path.join(ddir, f"depth{k}{sfx}.npy"),
                            depth[0].astype(np.float16))
                if write_embeds:
                    emb = teacher_embed(xyz[0], rgb[0], mask[0], d_embed)
                    np.save(os.path.join(ddir, f"embed{k}{sfx}.npy"), emb.astype(np.float16))
            rgb_h, _, _, _ = raytrace_views(scene, holdout_pose[None], h, w, focal,
                                            extra_boxes=gripper)
            write_png(os.path.join(ddir, f"holdout{k}.png"), _to_png(rgb_h[0]))
    return calib


def encode_task_instructions(instructions, seed: int = 0,
                             state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                             device="cuda") -> np.ndarray:
    """Per-task CLIP token embeddings (T, 77, 512) from the port's text tower
    (`models/clip_text.py`, 12 layers of width 512) on `device` ("cuda"
    unless the caller asks for "cpu"). The tower's weights are
    `state_dict` when given (e.g. converted from a flax tree by
    `convert.clip_text_to_state_dict`), else random from a torch.Generator
    seeded with `seed`: distinct instructions still map to stable,
    well-separated embeddings, which is what the policy's language
    cross-attention consumes."""
    from real_robot_nerf_actor_tpu_torch.models.clip_text import ClipTextEncoder, tokenize
    from real_robot_nerf_actor_tpu_torch.train.serve import resolve_device

    dev = resolve_device(device)
    enc = ClipTextEncoder()
    if state_dict is not None:
        enc.load_state_dict(state_dict)
    else:
        enc.reset_parameters(torch.Generator().manual_seed(seed))
    enc = enc.to(dev).eval()
    tokens = torch.as_tensor(tokenize(list(instructions)), device=dev)
    with torch.inference_mode():
        _, per_token = enc(tokens)
    return per_token.float().cpu().numpy()


def write_multi_kitchen_dataset(out: str, n_kitchens: int = 2, n_tasks: int = 3,
                                n_demos: int = 4, seed: int = 0, device="cuda",
                                lang_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                                **kitchen_kwargs) -> dict:
    """n_kitchens scenes x n_tasks language-conditioned tasks x n_demos
    demos: out/k{i}_t{j}/ (one recording per kitchen-task pair; kitchens
    differ in scene and camera), out/manifest.json and out/lang_embs.npz
    (the per-task token embeddings of `encode_task_instructions`, on
    `device`, with `lang_state_dict` as the tower's weights when given).
    Returns the manifest dict."""
    if n_tasks > len(TASK_INSTRUCTIONS):
        raise ValueError(f"only {len(TASK_INSTRUCTIONS)} task scripts defined")
    os.makedirs(out, exist_ok=True)
    center = np.array([0.35, 0.2, 0.1], np.float64)
    # one camera per kitchen: same range, rotated about the scene centre
    eyes = [center + np.array([0.9, -0.75, 0.85]),
            center + np.array([-0.55, -0.95, 0.9]),
            center + np.array([1.1, 0.35, 0.8]),
            center + np.array([0.2, 1.15, 0.95])]
    entries = []
    for ki in range(n_kitchens):
        sseed = seed + 101 * ki
        for ti in range(n_tasks):
            sub = f"k{ki}_t{ti}"
            write_kitchen_demos(
                os.path.join(out, sub), n_demos=n_demos, seed=seed + 1000 * ki + 100 * ti,
                task=ti, scene_seed=sseed, camera_eye=tuple(eyes[ki % len(eyes)]),
                **kitchen_kwargs)
            entries.append({"dir": sub, "kitchen": ki, "task": ti, "n_demos": n_demos,
                            "instruction": TASK_INSTRUCTIONS[ti]})
    lang = encode_task_instructions(TASK_INSTRUCTIONS[:n_tasks], seed=seed,
                                    state_dict=lang_state_dict, device=device)
    np.savez(os.path.join(out, "lang_embs.npz"), embs=lang,
             instructions=np.array(TASK_INSTRUCTIONS[:n_tasks]))
    manifest = {"n_kitchens": n_kitchens, "n_tasks": n_tasks, "n_demos": n_demos,
                "instructions": list(TASK_INSTRUCTIONS[:n_tasks]), "entries": entries}
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _write_xarm_position_file(path: str, demo) -> None:
    """The inverse of `data/keyframes.parse_xarm_position_file`: bracketed
    CSV, positions in mm, a True/False gripper flag."""
    with open(path, "w") as f:
        for k in range(demo.num_keyframes):
            x, y, z = (demo.xyz[k] * 1000.0).tolist()
            r, p, yw = demo.rotation[k].tolist()
            g = "True" if demo.gripper_open[k] > 0.5 else "False"
            f.write(f"[{x:.3f}, {y:.3f}, {z:.3f}, {r:.3f}, {p:.3f}, {yw:.3f}, {g}]\n")
