"""Reference of drivers/nerfact_train.py: the NeRF-Actor joint step in plain
PyTorch on the frozen copy of the port's plain paths, in the configuration's
dtypes (the policy and the field in bf16, the UNet encoder in fp32) with
TF32 off: SE(3) aug, voxelize, the PerceiverIO forward in train mode, the BC
losses, the render loss of sample 0 on the plain field, one backward and the
AdamW update of the program's optimizer config. It takes the benchmark's
weights, samples and draws, and nothing the program made.

Against an fp32 reference the bf16 model's first gradient swings from seed
to seed (the spatial softmax at temperature 0.01 amplifies bf16 rounding),
on the plain bf16 path alike, so fp32 could not tell the program from its
fp8 control (PERF.md)."""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from h100_bench.core import traffic
from h100_bench.core.control import LowerPrecision
from h100_bench.core.weights import occupied_share_bias, seeded_state
from h100_bench.reference.frozen.models.nerf_field import VoxelNerfField
from h100_bench.reference.frozen.models.perceiver import PerceiverConfig, PerceiverIO
from h100_bench.reference.frozen.ops.action_codec import DiscreteAction
from h100_bench.reference.frozen.ops.se3_aug import apply_se3_augmentation
from h100_bench.reference.frozen.ops.voxelize import VoxelizerSpec, voxelize
from h100_bench.reference.frozen.render.renderer import NeuralRenderer, RendererConfig
from h100_bench.reference.frozen.utils_config import from_dict


def plain_configs(program: dict):
    """The frozen PerceiverConfig and RendererConfig of a NerfActConfig dict
    on the plain paths, in the configuration's dtypes."""
    model = dict(program["peract"]["model"], conv_backend="conv2d",
                 use_flash_attention=False, stats_backend="xla")
    rend = dict(program["renderer"], fused_gather="auto")
    rend["field"] = dict(rend["field"], mlp_backend="xla", int8_static_act=False,
                         gather_fused_mlp=False)
    return from_dict(PerceiverConfig, model), from_dict(RendererConfig, rend)


def plain_module(program: dict) -> nn.ModuleDict:
    mc, rc = plain_configs(program)
    return nn.ModuleDict({"policy": PerceiverIO(mc), "nerf": VoxelNerfField(rc.field)})


def initial_state(program: dict, seed: int, device, sample: dict,
                  occupied_share: float) -> Dict[str, torch.Tensor]:
    """The run's weights, in the plain module's layout, the field's density
    bias set so that `occupied_share` of the workspace's cells hold density
    in the scene of `sample` (a batch of one, as the pool stages it)."""
    net = plain_module(program).to(device)
    sd = seeded_state(net, traffic.generator(seed, traffic.WEIGHTS, device))
    net.load_state_dict(sd)
    pe = program["peract"]
    bounds = torch.tensor(pe["coord_bounds"], dtype=torch.float32, device=device)
    with torch.no_grad():
        vox = voxelize(sample["points"], sample["colors"], bounds,
                       from_dict(VoxelizerSpec, pe["voxelizer"]), valid=sample["valid"])
        sd["nerf.mlp_coarse.lin_out_bias"][3] = occupied_share_bias(
            net["policy"], net["nerf"], {"vox": vox, "proprio": sample["proprio"],
                                         "lang": sample["lang"]},
            occupied_share, pe["coord_bounds"], train=True)
    return sd


def _ce(logits, labels):
    labels = labels.long()
    labels = torch.where(labels < 0, labels + logits.shape[-1], labels)
    return torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[:, None])[:, 0]


def bc_losses(q_trans, q_rot_grip, q_collision, action: DiscreteAction, v: int, r: int):
    """Integer-label cross-entropy of every head against the expert action,
    summed per sample, averaged over the batch."""
    b = q_trans.shape[0]
    t = action.trans.long()
    trans = _ce(q_trans.reshape(b, -1), (t[:, 0] * v + t[:, 1]) * v + t[:, 2])
    rg = action.rot_grip
    rot_grip = (_ce(q_rot_grip[:, :r], rg[:, 0]) + _ce(q_rot_grip[:, r:2 * r], rg[:, 1])
                + _ce(q_rot_grip[:, 2 * r:3 * r], rg[:, 2]) + _ce(q_rot_grip[:, 3 * r:], rg[:, 3]))
    return torch.mean(trans + rot_grip + _ce(q_collision, action.collision[:, 0]))


def schedule(o: dict):
    """The learning rate at the count of updates: optax's warmup-cosine (from
    0 over warmup_steps) or a constant, in fp32."""
    f32 = np.float32
    if o.get("schedule", "constant") != "cosine":
        return lambda count: o["lr"]
    peak, end = o["lr"], o["min_lr_frac"] * o["lr"]
    init = 0.0 if o["warmup_steps"] > 0 else peak
    warm = max(o["warmup_steps"], 1)
    span = float(o["decay_steps"] - warm)

    def lr(count):
        if count < warm:
            return float(f32(init - peak) * (f32(1) - f32(count) / f32(warm)) + f32(peak))
        c = f32(min(float(count - warm), span))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(span)))
        return float(f32(peak) * (f32(1 - end / peak) * cos + f32(end / peak)))
    return lr


class AdamW:
    """Decoupled AdamW (b1 0.9, b2 0.999 as fp32 values, eps 1e-8), skipping
    an update whose gradient is not finite."""

    def __init__(self, params: List[torch.Tensor], o: dict):
        self.params, self.lr, self.wd = params, schedule(o), o["weight_decay"]
        self.b1, self.b2 = float(np.float32(0.9)), float(np.float32(0.999))
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if not all(torch.isfinite(g).all() for g in grads):
            return
        lr, t = self.lr(self.count), self.count + 1
        bc1, bc2 = 1 - self.b1 ** t, 1 - self.b2 ** t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.mul_(1 - lr * self.wd)
            p.addcdiv_(m, v.sqrt() / bc2 ** 0.5 + 1e-8, value=-lr / bc1)
        self.count += 1


def joint_loss(net, rend, program: dict, batch: dict, d: dict, fault: Optional[str] = None):
    """The step's total loss and its render term (the port's
    NerfActTrainer.losses)."""
    pe = program["peract"]
    dev = batch["points"].device
    bounds = torch.tensor(pe["coord_bounds"], dtype=torch.float32, device=dev)
    v = pe["model"]["voxel_size"]
    aug = apply_se3_augmentation(batch["points"], batch["kf_xyz"], bounds,
                                 torch.tensor(pe["trans_aug_range"], device=dev), v,
                                 symmetric_clamp=pe["se3_symmetric_clamp"], u=d["draws"])
    proprio = torch.cat([aug.action_trans[:, 0].float(), batch["proprio"][:, 3:]], dim=-1)
    vox = voxelize(aug.pcd, batch["colors"], bounds, from_dict(VoxelizerSpec, pe["voxelizer"]),
                   valid=batch["valid"])
    out = net["policy"](vox, proprio, batch["lang"], train=True)
    action = DiscreteAction(trans=aug.action_trans[:, 1], rot_grip=batch["rot_grip"],
                            collision=batch["collision"])
    bc = bc_losses(out[0], out[1], out[2], action, v, pe["model"].get("num_rotation_classes", 72))
    pose = batch["gt_pose"].clone()
    pose[:, :3, 3] += aug.shift
    ray_idx, rdraws = d["ray_idx"], d["render_draws"]
    if fault == "half_rays":      # half the rays left out, the mean over the rest
        half = ray_idx.shape[0] // 2
        ray_idx, rdraws = ray_idx[:half], {k: x[:half] for k, x in rdraws.items()}
    render, _ = rend.rendering_loss(out[3][:1], batch["gt_rgb"][:1], pose[:1], batch["focal"][0],
                                    None, gt_embed=batch["gt_embed"][:1],
                                    gt_depth=batch["gt_depth"][:1], ray_idx=ray_idx,
                                    draws=rdraws)
    return program["lambda_bc"] * bc + program["lambda_nerf"] * render, render


def joint_steps(program: dict, sd: Dict[str, torch.Tensor], samples: List[dict],
                draws: List[dict], device, lower: Optional[str] = None,
                fault: Optional[str] = None) -> dict:
    """The reference's steps from `sd` on the samples and draws: each step's
    loss and render term, the first step's gradient norm by leaf, and each
    leaf's change over all the steps. lower: the control's precision;
    fault: a planted fault ("half_rays")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = plain_module(program).to(device)
    net.load_state_dict(sd)
    net.train()
    rend = NeuralRenderer(plain_configs(program)[1], device=device)
    rend.field = net["nerf"]
    named = list(net.named_parameters())
    opt = AdamW([p for _, p in named], program["peract"]["train"]["optim"])
    start = {n: p.detach().clone() for n, p in named}
    losses, renders, grads = [], [], {}
    for i, (batch, d) in enumerate(zip(samples, draws)):
        net.zero_grad(set_to_none=True)
        with LowerPrecision(lower) if lower else contextlib.nullcontext():
            total, render = joint_loss(net, rend, program, batch, d, fault)
            total.backward()
        losses.append(float(total.detach()))
        renders.append(float(render.detach()))
        if i == 0:
            grads = {n: float(p.grad.norm()) if p.grad is not None else 0.0 for n, p in named}
        opt.step()
    change = {n: float((p.detach() - start[n]).norm()) for n, p in named}
    return {"losses": losses, "render_losses": renders, "grad": grads, "change": change}
