"""Closed-loop deployment: capture -> voxelize -> policy -> decode -> move
(counterpart of the JAX package's `train/serve.py`).

`PolicyServer.act` runs the whole control step on the device: proprio
discretization, scatter voxelization, the PerceiverIO forward, the argmax
decode and the voxel index -> pose conversion, returning one packed
(B, 8) row [xyz, rot_deg, grip, coll] that crosses to the host once.
`run_deployment` drives that step against a `RobotIO`;
`run_deployment_scan` runs a recorded horizon as a loop over its steps.
`CameraActor` is the reference's real-camera front end on that step: raw
RealSense depth through the filter chain on the host, then camera-frame
and world points, the crop to the bounds and the act step on the device.

Entry points run on CUDA unless the caller passes device="cpu"; without a
CUDA device they raise rather than fall back.

    python -m real_robot_nerf_actor_tpu_torch.train.serve --steps 5
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from real_robot_nerf_actor_tpu_torch.data.depth_filters import (
    DepthFilterPipeline, depth_to_pointcloud)
from real_robot_nerf_actor_tpu_torch.data.replay import (
    ReplayStep, RobotIO, pad_point_cloud)
from real_robot_nerf_actor_tpu_torch.models.blocks import Conv3DBlock
from real_robot_nerf_actor_tpu_torch.models.perceiver import (
    PerceiverConfig, PerceiverIO)
from real_robot_nerf_actor_tpu_torch.ops import (
    VoxelizerSpec, choose_highest_action, discretize_action, voxelize)
from real_robot_nerf_actor_tpu_torch.ops.geometry import (
    transform_points, voxel_index_to_point)
from real_robot_nerf_actor_tpu_torch.ops.voxelize import pad_points


@dataclasses.dataclass
class ServeConfig:
    coord_bounds: Tuple[float, ...] = (-0.1, -0.3, -0.2, 0.8, 0.7, 0.7)
    rotation_resolution: float = 5.0
    num_steps: int = 20


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing CUDA where there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "on the CPU")
    return dev


class PolicyServer:
    """The act step around a PerceiverIO with the weights of `state_dict`
    (the port's module layout; see convert.py for flax trees)."""

    def __init__(self, cfg: ServeConfig, model_cfg: PerceiverConfig,
                 voxelizer: VoxelizerSpec,
                 state_dict: Mapping[str, torch.Tensor], lang_embs: np.ndarray,
                 device="cuda"):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.voxelizer = voxelizer
        self.device = resolve_device(device)
        self.net = PerceiverIO(model_cfg)
        self.net.load_state_dict(state_dict)
        self.net.to(self.device).eval()
        for m in self.net.modules():   # the k3 kernel's weight, cast once
            if isinstance(m, Conv3DBlock):
                m.cast_kernel_()
        self.lang = torch.as_tensor(np.asarray(lang_embs, np.float32),
                                    device=self.device)[None]
        self.bounds = torch.as_tensor(cfg.coord_bounds, dtype=torch.float32,
                                      device=self.device)

    @torch.inference_mode()
    def step(self, points, colors, valid, prop_xyz, prop_rot, prop_grip):
        """The whole control step on device tensors with a batch axis:
        raw proprio in, packed (B, 8) [xyz, rot_deg, grip, coll] out."""
        mc, rr = self.model_cfg, self.cfg.rotation_resolution
        prev = discretize_action(prop_xyz, prop_rot, prop_grip,
                                 torch.ones_like(prop_grip), self.bounds,
                                 mc.voxel_size, rr)
        proprio = torch.cat([prev.trans.float(), prev.rot_grip.float()], dim=-1)
        vox = voxelize(points, colors, self.bounds, self.voxelizer, valid=valid)
        q_trans, q_rot_grip, q_coll = self.net(vox, proprio, self.lang)[:3]
        coords, rot_grip, coll = choose_highest_action(q_trans, q_rot_grip,
                                                       q_coll, rr)
        xyz = voxel_index_to_point(coords, mc.voxel_size, self.bounds)
        rot_deg = (rot_grip[:, :3].float() + 1.0) * rr - 180.0
        return torch.cat([xyz, rot_deg, rot_grip[:, 3:4].float(),
                          coll[:, :1].float()], dim=-1)

    def act(self, points: np.ndarray, colors: np.ndarray, valid: np.ndarray,
            proprio_xyz: np.ndarray, proprio_rot: np.ndarray,
            proprio_grip: float):
        """One control step -> (xyz (3,), rotation deg (3,), gripper_open,
        collision)."""
        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)[None]

        packed = self.step(dev(points, torch.float32), dev(colors, torch.float32),
                           dev(valid, torch.bool), dev(proprio_xyz, torch.float32),
                           dev(proprio_rot, torch.float32),
                           dev(proprio_grip, torch.float32))[0].cpu().numpy()
        return packed[:3], packed[3:6], int(packed[6]), int(packed[7])


def camera_points(depth_m: np.ndarray, rgb: np.ndarray, intrinsics: np.ndarray,
                  cam_to_world: torch.Tensor, bounds: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A filtered depth frame (H, W) and its colour frame (H, W, 3) -> the
    world points of the valid pixels inside `bounds`, (N, 3) in pixel order,
    and their colours in [-1, 1], on the device of `cam_to_world` (4 x 4):
    depth_to_pointcloud, then transform_points."""
    dev = cam_to_world.device
    cam = depth_to_pointcloud(depth_m, intrinsics, device=dev).reshape(-1, 3)
    world = transform_points(cam, cam_to_world)
    rgb_t = torch.as_tensor(np.asarray(rgb)).to(dev)
    if rgb_t.dtype == torch.uint8:
        rgb_t = rgb_t.float() / 255.0
    cols = (rgb_t.float().reshape(-1, 3) - 0.5) / 0.5
    keep = ((cam[:, 2] > 0) & (world >= bounds[:3]).all(dim=-1)
            & (world <= bounds[3:]).all(dim=-1))
    return world[keep], cols[keep]


class CameraActor:
    """The reference's real-camera act path (read_real_data_kitchen.py:55-160,
    then the act step) around a PolicyServer:

      raw depth (H, W) in metres -> `DepthFilterPipeline` on the host
      (disparity, spatial and temporal filters, the 1 m clip; the temporal
      state carries from frame to frame) -> `depth_to_pointcloud` and
      `transform_points` by the camera-to-world extrinsic on the server's
      device -> the valid points inside coord_bounds, in pixel order, padded
      or truncated to max_num_coords -> `PolicyServer.step`.

    rgb is the colour frame aligned to the depth, (H, W, 3) uint8 or floats
    in [0, 1], mapped to [-1, 1] as the replay loader maps PLY colours."""

    def __init__(self, server: PolicyServer, intrinsics: np.ndarray,
                 cam_to_world: np.ndarray,
                 filters: Optional[DepthFilterPipeline] = None):
        self.server = server
        self.device = server.device
        self.intrinsics = np.asarray(intrinsics, np.float64)
        self.cam_to_world = torch.as_tensor(np.asarray(cam_to_world, np.float32),
                                            device=self.device)
        self.filters = filters if filters is not None else DepthFilterPipeline()
        self.last_num_points = 0

    def reset(self):
        """Forget the temporal filter's history (a new episode)."""
        self.filters.reset()

    def points(self, depth_m: np.ndarray, rgb: np.ndarray
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A filtered depth frame and its colours -> the world points inside
        the bounds, (N, 3), and their colours, on the device."""
        return camera_points(depth_m, rgb, self.intrinsics, self.cam_to_world,
                             self.server.bounds)

    def step(self, depth_filtered: np.ndarray, rgb: np.ndarray, proprio_xyz,
             proprio_rot, proprio_grip) -> torch.Tensor:
        """The device part on a filtered frame: packed (1, 8) [xyz,
        rot_deg, grip, coll] as PolicyServer.step returns it."""
        pts, cols = self.points(depth_filtered, rgb)
        self.last_num_points = int(pts.shape[0])
        pts, cols, valid = pad_points(pts[None], cols[None],
                                      self.server.voxelizer.max_num_coords)

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(self.device)[None]

        return self.server.step(pts, cols, valid, dev(proprio_xyz), dev(proprio_rot),
                                dev(proprio_grip))

    def act(self, depth_m: np.ndarray, rgb: np.ndarray, proprio_xyz: np.ndarray,
            proprio_rot: np.ndarray, proprio_grip: float):
        """One control step from a raw depth frame -> (xyz (3,), rotation
        deg (3,), gripper_open, collision), as PolicyServer.act."""
        packed = self.step(self.filters(depth_m), rgb, proprio_xyz, proprio_rot,
                           proprio_grip)[0].cpu().numpy()
        return packed[:3], packed[3:6], int(packed[6]), int(packed[7])


def run_deployment(server: PolicyServer, robot: RobotIO,
                   safety_check: Optional[Callable] = None,
                   num_steps: Optional[int] = None) -> List[dict]:
    """The capture -> infer -> move loop; returns the action trace."""
    trace = []
    steps = num_steps if num_steps is not None else server.cfg.num_steps
    for t in range(steps):
        obs = robot.capture_pointcloud()
        pts, cols, valid = pad_point_cloud(obs, server.voxelizer.max_num_coords)
        xyz_p, rot_p, grip_p = robot.get_proprio()
        xyz, rot_deg, grip, coll = server.act(pts, cols, valid, xyz_p, rot_p,
                                              grip_p)
        action = {"step": t, "xyz": xyz, "rotation": rot_deg,
                  "gripper_open": grip, "ignore_collision": coll}
        if safety_check is not None and not safety_check(action, obs):
            action["aborted"] = True
            trace.append(action)
            break
        robot.move_to(xyz, rot_deg, float(grip))
        trace.append(action)
    return trace


def run_deployment_scan(server: PolicyServer, steps: Sequence[ReplayStep],
                        robot: Optional[RobotIO] = None) -> List[dict]:
    """Replay validation: every recorded step through the act step, in
    order (the observations are fixed, so the actions are the same as
    run_deployment's over a ReplayRobotIO); the decoded commands are then
    replayed into `robot` if one is given."""
    trace = []
    for t, s in enumerate(steps):
        pts, cols, valid = pad_point_cloud(s.observation,
                                           server.voxelizer.max_num_coords)
        xyz, rot_deg, grip, coll = server.act(pts, cols, valid, s.proprio_xyz,
                                              s.proprio_rot, s.proprio_grip)
        trace.append({"step": t, "xyz": xyz, "rotation": rot_deg,
                      "gripper_open": grip, "ignore_collision": coll})
    if robot is not None:
        for a in trace:
            robot.move_to(a["xyz"], a["rotation"], float(a["gripper_open"]))
    return trace


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Closed-loop deployment over a replayed synthetic scene with a
    randomly initialised policy (the counterpart of scripts/serve_policy.py,
    without checkpoint loading)."""
    from real_robot_nerf_actor_tpu_torch.data.replay import ReplayRobotIO
    from real_robot_nerf_actor_tpu_torch.data.synthetic import (
        make_replay_steps, make_synthetic_demo, make_synthetic_scene)
    from real_robot_nerf_actor_tpu_torch.train.peract import PerActConfig
    from real_robot_nerf_actor_tpu_torch.utils.config import apply_override

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0, help="weights' seed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("-o", "--override", action="append", default=[],
                    help="PerActConfig dot-override, e.g. model.depth=2")
    args = ap.parse_args(argv)

    cfg = PerActConfig()
    for ov in args.override:
        k, _, v = ov.partition("=")
        cfg = apply_override(cfg, k.strip(), v.strip())
    device = resolve_device(args.device)
    net = PerceiverIO.initialized(
        cfg.model, torch.Generator().manual_seed(args.seed))
    scene = make_synthetic_scene(seed=0)
    robot = ReplayRobotIO(make_replay_steps(scene, make_synthetic_demo(scene)))
    server = PolicyServer(
        ServeConfig(coord_bounds=cfg.coord_bounds,
                    rotation_resolution=cfg.rotation_resolution,
                    num_steps=args.steps),
        cfg.model, cfg.voxelizer, net.state_dict(),
        np.zeros((cfg.model.lang_max_seq_len, cfg.model.lang_emb_dim),
                 np.float32), device=device)
    trace = run_deployment(server, robot)
    for a in trace:
        print(a["step"], a["xyz"].round(3), a["rotation"].round(1),
              "grip", a["gripper_open"])
    return trace


if __name__ == "__main__":
    main()
