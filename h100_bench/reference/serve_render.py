"""Reference of drivers/serve_render.py: the serving frame in plain PyTorch
on the frozen copy of the port's plain paths, with TF32 off. It derives
again what the program's set-up derived from the benchmark's weights and
cloud: the policy's voxel features d0 and the field's occupancy probes in
the configuration's dtypes (bf16), each pose's ray plan; it renders the
checked frames on the plain field in fp32 with the same draws."""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from h100_bench.core import traffic
from h100_bench.core.control import LowerPrecision
from h100_bench.core.weights import occupied_share_bias, seeded_state
from h100_bench.reference.frozen.models.nerf_field import VoxelNerfField
from h100_bench.reference.frozen.models.perceiver import PerceiverConfig, PerceiverIO
from h100_bench.reference.frozen.ops.voxelize import VoxelizerSpec, voxelize
from h100_bench.reference.frozen.render.renderer import NeuralRenderer, RendererConfig
from h100_bench.reference.frozen.utils_config import from_dict


def plain_configs(program: dict, frame, field_dtype: Optional[str] = None):
    """The frozen PerceiverConfig (the policy in the configuration's dtypes)
    and RendererConfig (the plain field, in field_dtype or the
    configuration's), frame (H, W)."""
    model = dict(program["peract"]["model"], conv_backend="conv2d",
                 use_flash_attention=False, stats_backend="xla")
    rend = dict(program["renderer"], image_height=frame[0], image_width=frame[1],
                fused_gather="auto")
    rend["field"] = dict(rend["field"], mlp_backend="xla", int8_static_act=False,
                         gather_fused_mlp=False)
    if field_dtype:
        rend["field"]["compute_dtype"] = field_dtype
    return from_dict(PerceiverConfig, model), from_dict(RendererConfig, rend)


def _policy(program: dict, frame, sd: Dict[str, torch.Tensor], device) -> nn.Module:
    policy = PerceiverIO(plain_configs(program, frame)[0]).to(device)
    policy.load_state_dict({k[7:]: v for k, v in sd.items() if k.startswith("policy.")})
    return policy.eval()


def _renderer(program: dict, frame, sd: Dict[str, torch.Tensor], device,
              field_dtype: Optional[str] = None) -> NeuralRenderer:
    rend = NeuralRenderer(plain_configs(program, frame, field_dtype)[1], device=device)
    rend.load_field({k[5:]: v for k, v in sd.items() if k.startswith("nerf.")})
    return rend


def voxel_grid(program: dict, cloud: dict) -> torch.Tensor:
    pe = program["peract"]
    bounds = torch.tensor(pe["coord_bounds"], dtype=torch.float32,
                          device=cloud["points"].device)
    return voxelize(cloud["points"], cloud["colors"], bounds,
                    from_dict(VoxelizerSpec, pe["voxelizer"]), valid=cloud["valid"])


def initial_state(program: dict, frame, seed: int, device, cloud: dict,
                  occupied_share: float) -> Dict[str, torch.Tensor]:
    """The run's weights in the plain layout (policy.*, nerf.*), the field's
    density bias set so that `occupied_share` of the workspace's cells hold
    density in the scene of `cloud`."""
    mc, rc = plain_configs(program, frame)
    net = nn.ModuleDict({"policy": PerceiverIO(mc), "nerf": VoxelNerfField(rc.field)})
    sd = seeded_state(net, traffic.generator(seed, traffic.WEIGHTS, device))
    with torch.no_grad():
        vox = voxel_grid(program, cloud)
        bias = occupied_share_bias(
            _policy(program, frame, sd, device), _renderer(program, frame, sd, device).field,
            {"vox": vox, "proprio": cloud["proprio"], "lang": cloud["lang"]}, occupied_share,
            program["peract"]["coord_bounds"], rc.occ_pool, rc.occ_alpha_thresh)
    sd["nerf.mlp_coarse.lin_out_bias"][3] = bias
    return sd


@torch.no_grad()
def scene(program: dict, frame, sd: Dict[str, torch.Tensor], cloud: dict, prepare_seed: int,
          device):
    """The policy's voxel features d0 of `cloud` and the renderer's
    occupancy from them, the field's probes drawn from prepare_seed."""
    vox = voxel_grid(program, cloud)
    d0 = _policy(program, frame, sd, device)(vox, cloud["proprio"], cloud["lang"])[3].float()
    occ = _renderer(program, frame, sd, device).prepare(
        d0, occupancy=vox[0, ..., -1],
        generator=torch.Generator(device=device).manual_seed(prepare_seed))
    return d0, occ


def frames(program: dict, frame, sd: Dict[str, torch.Tensor], cloud: dict, poses,
           focal: float, prepare_seed: int, frame_seeds: List[int], device,
           embed_stride: int = 8, lower: Optional[str] = None) -> List[tuple]:
    """(rgb, depth, embed on every embed_stride-th pixel row and column) of
    the frame from each pose with each seed's draws; lower renders in the
    control's precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d0, occ = scene(program, frame, sd, cloud, prepare_seed, device)
    rend = _renderer(program, frame, sd, device, field_dtype="float32")
    out = []
    for pose, fs in zip(poses, frame_seeds):
        pose = torch.as_tensor(pose, device=device)[None]
        plan = rend.plan_rays(occ, pose, focal)
        with LowerPrecision(lower) if lower else contextlib.nullcontext():
            rgb, embed, depth = rend.render_image(
                d0, pose, focal, generator=torch.Generator(device=device).manual_seed(fs),
                occ=occ, plan=plan)
        out.append((rgb, depth, embed[::embed_stride, ::embed_stride].clone()))
    return out
