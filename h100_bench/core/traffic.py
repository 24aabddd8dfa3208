"""The general traffic generator: every cell's inputs from its traffic file's
parameters and the run's seed. The same seed gives the same inputs; every
seed gives the same set of sizes, in another order."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from h100_bench.core import scenes

# streams of one seed: weights, staged inputs, per-step draws, host scenes
WEIGHTS, INPUTS, DRAWS = 0, 1, 2


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed * 4 + stream)


def host_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng([seed, 3])


def sizes(lo: int, hi: int, n: int, rng: np.random.Generator) -> List[int]:
    """n cloud sizes evenly spread over [lo, hi], in the seed's order."""
    return [int(x) for x in rng.permutation(np.linspace(lo, hi, n).round().astype(int))]


def keyframe_pool(t: dict, bounds, rotation_resolution: float, voxel_size: int,
                  d_embed: int, lang_shape, seed: int, device) -> Dict[str, torch.Tensor]:
    """t["pool"] keyframe samples, stacked on the device: a scene of a
    size from t["points"] padded to t["pad_to"] rows (points, colors,
    valid), a transition of its grasp demo (kf_xyz (2, 3), proprio (7,):
    zeros then the current keyframe's discrete rotation and grip, rot_grip
    and collision of the next), the scene raytraced from a pose on the
    orbit (gt_rgb, gt_depth, gt_pose, focal), gt_embed N(0, embed_std^2)
    and lang N(0, 1) drawn on the device (stand-ins for the teacher and the
    text tower). A demo whose rotation falls outside the policy's bins (the
    codec's off-by-one shift puts 180 + 5 degrees in bin 72 of 72) is drawn
    again."""
    from h100_bench.reference.frozen.ops.action_codec import discretize_action

    rng = host_rng(seed)
    n = t["pool"]
    h, w = t["view"]
    poses = scenes.orbit_poses(n, phase=float(rng.uniform(0, 2 * np.pi)))
    out = {k: [] for k in ("points", "colors", "valid", "kf_xyz", "proprio", "rot_grip",
                           "collision", "gt_rgb", "gt_depth", "gt_pose")}
    b = torch.as_tensor(bounds, dtype=torch.float32)
    for i, npts in enumerate(sizes(*t["points"], n, rng)):
        scene = scenes.make_synthetic_scene(seed=int(rng.integers(2 ** 31)), n_points=npts,
                                            bounds=tuple(bounds))
        while True:   # a demo whose rotation bins are all classes of the policy
            demo = scenes.make_synthetic_demo(scene, seed=int(rng.integers(2 ** 31)))
            nk = demo.xyz.shape[0]
            disc = discretize_action(torch.as_tensor(demo.xyz), torch.as_tensor(demo.rotation),
                                     torch.as_tensor(demo.gripper_open), torch.ones((nk,)),
                                     b, voxel_size, rotation_resolution)
            if int(disc.rot_grip[:, :3].max()) < round(360 / rotation_resolution):
                break
        k = int(rng.integers(0, nk - 1))
        pts, cols, valid = scenes.pad_cloud(scene.points, scene.colors, t["pad_to"])
        rgb, depth, _, _ = scenes.raytrace_views(scene, poses[i:i + 1], h, w, t["focal"])
        rg = disc.rot_grip.numpy()
        for key, a in (("points", pts), ("colors", cols), ("valid", valid),
                       ("kf_xyz", demo.xyz[k:k + 2]),
                       ("proprio", np.concatenate([np.zeros(3, np.float32),
                                                   rg[k].astype(np.float32)])),
                       ("rot_grip", rg[k + 1]), ("collision", disc.collision.numpy()[k + 1]),
                       ("gt_rgb", rgb[0]), ("gt_depth", depth[0]), ("gt_pose", poses[i])):
            out[key].append(np.asarray(a))
    pool = {k: torch.as_tensor(np.stack(v)).to(device) for k, v in out.items()}
    g = generator(seed, INPUTS, device)
    pool["focal"] = torch.full((n,), float(t["focal"]), device=device)
    pool["gt_embed"] = torch.randn((n, h, w, d_embed), generator=g, device=device) * t["embed_std"]
    pool["lang"] = torch.randn((n,) + tuple(lang_shape), generator=g, device=device)
    return pool


def pool_order(n: int, seed: int) -> np.ndarray:
    """The order a run takes the pool's samples in: all differ in each
    pass of n steps."""
    return np.random.default_rng([seed, 5]).permutation(n)


def train_draws(g: torch.Generator, batch: int, rays: int, n_coarse: int, n_fine: int,
                n_fine_depth: int, pixels: int) -> dict:
    """One joint step's draws: the SE(3) shifts' uniforms in [-1, 1), the
    rendered rays, and the renderer's sample draws."""
    dev = g.device
    nf = n_fine - n_fine_depth
    return {"draws": torch.rand((batch, 3), generator=g, device=dev) * 2.0 - 1.0,
            "ray_idx": torch.randint(0, pixels, (rays,), generator=g, device=dev),
            "render_draws": {
                "coarse_u": torch.rand((rays, n_coarse), generator=g, device=dev),
                "fine_u": torch.rand((rays, nf), generator=g, device=dev),
                "fine_jitter": torch.rand((rays, nf), generator=g, device=dev),
                "fine_depth_eps": torch.randn((rays, n_fine_depth), generator=g, device=dev)}}
