"""Seeded weights, made by the benchmark on the device in one draw and handed
to the program and the reference alike, in the reference's layout: every
matrix and kernel N(0, 1/fan_in), the learned position code and latents
N(0, 1), norms' scales one, biases zero; buffers as the modules make them.
The NeRF field's density bias is then set from the seed's scene, so that a
fixed share of the workspace holds density on every seed
(`occupied_share_bias`)."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

UNIT_STD = ("pos_encoding", "latents")


def _fan_in(module: nn.Module, name: str, p: torch.Tensor) -> int:
    if name.endswith("kernel") and p.dim() == 2:      # (in, out)
        return p.shape[0]
    if type(module).__name__ == "ConvTranspose3d":     # (in, out, k, k, k)
        return p.numel() // p.shape[1]
    return p.numel() // p.shape[0]                    # (out, in, ...)


def seeded_state(module: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The state dict of `module` (on the generator's device) with weights
    drawn from `generator`: one normal draw for all of them, scaled leaf by
    leaf."""
    dev = generator.device
    mods = dict(module.named_modules())
    params = list(module.named_parameters())
    big = [(n, p) for n, p in params if p.dim() >= 2]
    flat = torch.randn(sum(p.numel() for _, p in big), generator=generator, device=dev)
    sd = {k: v.detach().to(dev).clone() for k, v in module.state_dict().items()}
    off = 0
    for n, p in big:
        owner, leaf = n.rsplit(".", 1) if "." in n else ("", n)
        std = 1.0 if leaf in UNIT_STD else _fan_in(mods[owner], leaf, p) ** -0.5
        sd[n] = (flat[off:off + p.numel()].view(p.shape) * std).to(p.dtype)
        off += p.numel()
    for n, p in params:
        if p.dim() < 2:
            owner, leaf = n.rsplit(".", 1) if "." in n else ("", n)
            norm = type(mods[owner]).__name__ in ("LayerNorm", "BatchNorm")
            sd[n] = torch.full(p.shape, 1.0 if norm and leaf in ("weight", "scale") else 0.0,
                               dtype=p.dtype, device=dev)
    return sd


@torch.no_grad()
def occupied_share_bias(policy: nn.Module, field: nn.Module, inputs: dict, share: float,
                        coord_bounds, pool: int = 4, alpha: float = 0.01,
                        train: bool = False) -> float:
    """The field's density bias (the seeded one is zero) at which `share` of
    the workspace's cells of `pool`^3 voxels hold density over the
    occupancy threshold (alpha over one cell's width) at their centres,
    given the policy's voxel features of `inputs` (the voxel grid `vox`,
    proprio, lang). The seeded draw alone leaves the density's level to the
    seed: all but empty on some seeds, filling the box on others."""
    d0 = policy(inputs["vox"], inputs["proprio"], inputs["lang"], train=train)[3][:1].float()
    vp = d0.shape[1] // pool
    b = torch.as_tensor(coord_bounds, dtype=torch.float32, device=d0.device)
    ar = (torch.arange(vp, dtype=torch.float32, device=d0.device) + 0.5) / vp
    grid = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1).reshape(1, -1, 3)
    pts = b[:3] + grid * (b[3:] - b[:3])
    dirs = torch.tensor([0.0, 0.0, -1.0], device=d0.device).expand(pts.shape)
    hidden = field(d0, pts, dirs, coarse=True, compact_heads=True)["hidden"][0]
    pre = (hidden @ field.mlp_coarse.lin_out_kernel[:, 3:4].to(hidden.dtype)).float()[:, 0]
    cell = float(((b[3:] - b[:3]) / vp).min())
    return -math.log(1.0 - alpha) / cell - float(torch.quantile(pre, 1.0 - share))
