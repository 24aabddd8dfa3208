"""Cell driver: the serving frame, `NeuralRenderer.render_image` of the
port, closed loop, one frame at a time, round-robin over a fixed camera
orbit.

Set-up derives the scene once, as serving does: the policy's voxel
features d0 of a seeded cloud, `prepare` (occupancy), `calibrate_int8_act`
(static int8 scales) and one `plan_rays` a pose. The seeded field holds
density in the traffic's `occupied_share` of the workspace on every seed. A frame is complete when
its pixels are on the device and the device has finished; culled
background pixels count as delivered. `check` renders a seed-drawn sample
of the window's frames again in the reference."""
from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

from h100_bench.core import counts, scenes, traffic
from h100_bench.core.window import phase
from h100_bench.reference import serve_render as ref


def frame_seed(seed: int, i: int) -> int:
    return (seed * 4 + traffic.DRAWS) * 2 ** 20 + i


def cloud_inputs(t: dict, program: dict, seed: int, device) -> dict:
    """The seeded cloud the scene's d0 comes from, padded, with zero proprio
    and seeded language embeddings (a stand-in for the text tower)."""
    rng = traffic.host_rng(seed)
    m = program["peract"]["model"]
    scene = scenes.make_synthetic_scene(seed=int(rng.integers(2 ** 31)),
                                        n_points=t["cloud_points"],
                                        bounds=tuple(program["peract"]["coord_bounds"]))
    pts, cols, valid = scenes.pad_cloud(scene.points, scene.colors, t["pad_to"])
    g = traffic.generator(seed, traffic.INPUTS, device)
    return {"points": torch.as_tensor(pts, device=device)[None],
            "colors": torch.as_tensor(cols, device=device)[None],
            "valid": torch.as_tensor(valid, device=device)[None],
            "proprio": torch.zeros((1, m.get("low_dim_size", 7)), device=device),
            "lang": torch.randn((1, m.get("lang_max_seq_len", 77), m.get("lang_emb_dim", 512)),
                                generator=g, device=device)}


class Cell:
    def __init__(self, spec: dict, seed: int, device):
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.program = self.config["program"]
        self.seed, self.device = seed, torch.device(device)
        self.i = 0
        t = self.traffic
        self.frame = tuple(t["frame"])
        # the same poses for every seed (so the same rays to render), in the
        # seed's order
        self.poses = scenes.orbit_poses(t["poses"])[
            np.random.default_rng([seed, 6]).permutation(t["poses"])]
        # the frames kept for `check`: one in each block of check_every, at a
        # position drawn from the seed; `check` renders a sample of them
        self.rng = np.random.default_rng([seed, 7])
        self.kept: Dict[int, tuple] = {}

    def setup(self) -> None:
        from real_robot_nerf_actor_tpu_torch.models.perceiver import PerceiverConfig, PerceiverIO
        from real_robot_nerf_actor_tpu_torch.ops.voxelize import VoxelizerSpec, voxelize
        from real_robot_nerf_actor_tpu_torch.render.renderer import (
            NeuralRenderer, RendererConfig)
        from real_robot_nerf_actor_tpu_torch.utils.config import from_dict

        p, t, dev = self.program, self.traffic, self.device
        pe = p["peract"]
        rc = from_dict(RendererConfig, dict(p["renderer"], image_height=self.frame[0],
                                            image_width=self.frame[1]))
        with phase("weights_and_cloud", dev):
            self.cloud = cloud_inputs(t, p, self.seed, dev)
            sd = ref.initial_state(p, self.frame, self.seed, dev, self.cloud,
                                   t["occupied_share"])
        with phase("d0", dev):
            with torch.device(dev):
                policy = PerceiverIO(from_dict(PerceiverConfig, pe["model"]))
            policy.load_state_dict({k[7:]: v for k, v in sd.items() if k.startswith("policy.")})
            policy.eval()
            bounds = torch.tensor(pe["coord_bounds"], dtype=torch.float32, device=dev)
            c = self.cloud
            with torch.inference_mode():
                vox = voxelize(c["points"], c["colors"], bounds,
                               from_dict(VoxelizerSpec, pe["voxelizer"]), valid=c["valid"])
                self.d0 = policy(vox, c["proprio"], c["lang"])[3].float().contiguous()
            del policy
        with phase("scene", dev):
            self.rend = NeuralRenderer(rc, device=dev)
            self.rend.load_field({k[5:]: v for k, v in sd.items() if k.startswith("nerf.")})
            del sd
            gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
            self.occ = self.rend.prepare(self.d0, occupancy=vox[0, ..., -1],
                                         generator=gen(frame_seed(self.seed, 2 ** 19)))
            pose0 = torch.as_tensor(self.poses[0], device=dev)[None]
            self.rend.calibrate_int8_act(self.d0, self.rend.frame_rays(pose0, t["focal"]),
                                         generator=gen(frame_seed(self.seed, 2 ** 19 + 1)))
            self.pose_t = [torch.as_tensor(q, device=dev)[None] for q in self.poses]
            self.plans = [self.rend.plan_rays(self.occ, q, t["focal"]) for q in self.pose_t]
        print(f"setup occupancy {self.shares()}", file=sys.stderr)
        with phase("warmup_frames", dev):
            for k in range(t["warmup_frames"]):
                self._render(-1 - k)

    def shares(self) -> dict:
        """The share of the workspace's pooled cells that the occupancy
        holds, and of the frames' rays that the plans keep."""
        rays = len(self.plans) * self.frame[0] * self.frame[1]
        return {"occupied": float(self.occ.pooled.mean()),
                "active": sum(q.n_active for q in self.plans) / rays}

    def _render(self, i: int):
        k = i % len(self.poses)
        return self.rend.render_image(
            self.d0, self.pose_t[k], self.traffic["focal"],
            generator=torch.Generator(device=self.device).manual_seed(frame_seed(self.seed, i)),
            occ=self.occ, plan=self.plans[k])

    def step(self) -> int:
        rgb, embed, depth = self._render(self.i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        every = self.traffic["check_every"]
        if self.i % every == 0:
            self.keep_at = self.i + int(self.rng.integers(every))
        if self.i == self.keep_at:
            s = self.traffic["embed_stride"]
            self.kept[self.i] = (rgb, depth, embed[::s, ::s].clone())
        self.i += 1
        return self.frame[0] * self.frame[1]

    def end_to_end(self, record) -> Dict[str, float]:
        return {"render_rays_per_s": record.rate()}

    def attempted_failed(self, record):
        bad = sum(1 for rgb, depth, _ in self.kept.values()
                  if not (torch.isfinite(rgb).all() and torch.isfinite(depth).all()))
        return len(record.work), bad

    def window_closed(self) -> None:
        if not self.kept:
            raise RuntimeError("the window closed before a frame was kept for the check")
        n = min(self.traffic["checked_frames"], len(self.kept))
        self.checked_idx = sorted(int(i) for i in self.rng.choice(sorted(self.kept), n,
                                                                  replace=False))
        self.kept = {i: tuple(x.float().cpu() for x in self.kept[i]) for i in self.checked_idx}

    def free(self) -> None:
        self.rend = self.d0 = self.occ = self.plans = None

    # ------------------------------------------------------------ per layer
    def unit_work(self, i: int) -> dict:
        f = self.program["renderer"]
        fld = f["field"]
        tile = self.rend_tile()
        tiles = self.plans[i % len(self.poses)].idx.numel() // tile
        work = {"ray_expand": [], "corner_lerp": [], "fused_resnetfc_int8": []}
        for k in (f["n_coarse"], f["n_fine"]):
            n = k * tile
            work["ray_expand"] += [counts.ray_expand(tile, k, fld.get("num_freqs", 6))] * tiles
            work["corner_lerp"] += [counts.corner_lerp(n, fld["d_latent"])] * tiles
            work["fused_resnetfc_int8"] += [counts.resnetfc_int8(
                n, fld["d_hidden"], fld["n_blocks"], fld["combine_layer"], fld["d_latent"],
                fld.get("num_freqs", 6))] * tiles
        return work

    def rend_tile(self) -> int:
        return min(self.program["renderer"].get("render_tile", 4096),
                   self.plans[0].idx.numel())

    def unit_model_ops(self, i: int) -> Dict[str, float]:
        """A frame's field operations on its active rays' samples."""
        f = self.program["renderer"]
        fld = f["field"]
        rows = self.plans[i % len(self.poses)].n_active * (f["n_coarse"] + f["n_fine"])
        return counts.resnetfc_int8(rows, fld["d_hidden"], fld["n_blocks"],
                                    fld["combine_layer"], fld["d_latent"],
                                    fld.get("num_freqs", 6))[0]

    # --------------------------------------------------------------- check
    def reference_frames(self, lower=None) -> List[tuple]:
        t = self.traffic
        sd = ref.initial_state(self.program, self.frame, self.seed, self.device, self.cloud,
                               t["occupied_share"])
        return ref.frames(self.program, self.frame, sd, self.cloud,
                          [self.poses[i % len(self.poses)] for i in self.checked_idx],
                          t["focal"], frame_seed(self.seed, 2 ** 19),
                          [frame_seed(self.seed, i) for i in self.checked_idx], self.device,
                          t["embed_stride"], lower)

    def check(self) -> List[tuple]:
        want = [tuple(x.float().cpu() for x in w) for w in self.reference_frames()]
        got = [self.kept[i] for i in self.checked_idx]
        return compare(got, want, self.traffic["limits"])


def compare(got: List[tuple], want: List[tuple], limits: dict) -> List[tuple]:
    """rgb RMSE over every checked pixel, the embed's RMSE over the
    reference's RMS, the depth's RMSE over the reference's RMS."""
    def rms_gap(j):
        d = torch.cat([(g[j] - w[j]).reshape(-1) for g, w in zip(got, want)])
        return float(d.pow(2).mean().sqrt())

    def rms(j):
        return float(torch.cat([w[j].reshape(-1) for w in want]).pow(2).mean().sqrt())

    return [("rgb_rmse", rms_gap(0), limits["rgb_rmse"]),
            ("depth_rel_rmse", rms_gap(1) / max(rms(1), 1e-30), limits["depth_rel_rmse"]),
            ("embed_rel_rmse", rms_gap(2) / max(rms(2), 1e-30), limits["embed_rel_rmse"])]


def readings(cell: Cell, seconds: float) -> dict:
    """The numbers `check` compares, read for setting its limits: the
    program's (a short window's frames), the control's (the reference in int4
    in the program's place) and three planted faults': half of each frame's
    rendered rays left out (background there), every answer altered where
    it is produced (the colour channels in reverse order), and the program's
    occupancy filled (every cell occupied, the plans made again); with the
    occupied and active shares of the program's scene."""
    from h100_bench.core.window import run_window

    record = run_window(cell.step, seconds, cell.device)
    cell.window_closed()
    shares = cell.shares()
    occ = cell.occ
    sd = ref.initial_state(cell.program, cell.frame, cell.seed, cell.device, cell.cloud,
                           cell.traffic["occupied_share"])
    ref_occ = ref.scene(cell.program, cell.frame, sd, cell.cloud, frame_seed(cell.seed, 2 ** 19),
                        cell.device)[1]
    del sd
    shares.update(ref_occupied=float(ref_occ.pooled.mean()),
                  cells_differing=int((ref_occ.pooled != occ.pooled).sum()),
                  aabb=occ.aabb.tolist(), ref_aabb=ref_occ.aabb.tolist())
    cell.occ = occ._replace(pooled=torch.ones_like(occ.pooled),
                            aabb=torch.tensor([[0.0] * 3, [1.0] * 3], device=occ.aabb.device))
    cell.plans = [cell.rend.plan_rays(cell.occ, q, cell.traffic["focal"]) for q in cell.pose_t]
    filled = []
    for i in cell.checked_idx:
        rgb, embed, depth = cell._render(i)
        s = cell.traffic["embed_stride"]
        filled.append((rgb.float().cpu(), depth.float().cpu(), embed[::s, ::s].float().cpu()))
    cell.free()
    got = [cell.kept[i] for i in cell.checked_idx]
    want = [tuple(x.float().cpu() for x in w) for w in cell.reference_frames()]
    ctrl = [tuple(x.float().cpu() for x in w) for w in cell.reference_frames(lower="int4")]
    lim = cell.traffic["limits"]

    def half(frames):
        out = []
        for rgb, depth, emb in frames:
            rgb, depth, emb = rgb.clone(), depth.clone(), emb.clone()
            rgb[::2], depth[::2], emb[::2] = 0, 0, 0
            out.append((rgb, depth, emb))
        return out

    def swapped(frames):
        return [(rgb.flip(-1), depth, emb) for rgb, depth, emb in frames]

    return {"frames": len(record.work), "shares": shares, "program": compare(got, want, lim),
            "control_int4": compare(ctrl, want, lim),
            "fault_half_rays": compare(half(got), want, lim),
            "fault_channels_swapped": compare(swapped(got), want, lim),
            "fault_occupancy_filled": compare(filled, want, lim)}
