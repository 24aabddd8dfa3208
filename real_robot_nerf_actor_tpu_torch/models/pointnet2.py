"""PointNet++ set-abstraction encoder (counterpart of the JAX package's
`models/pointnet2.py`).

Three levels as the reference's classification backbone builds them:
(512 centroids, r 0.2, 32 neighbours, mlp 64/64/128), (128, 0.4, 64,
128/128/256), then group-all (256/512/1024) -> the (B, 1024) global feature.
The samplers are plain torch, as the JAX package has no kernel for them:
  - farthest_point_sample starts at point 0 and takes `argmax`'s first
    maximum of the running minimum distance, one centroid per step (npoint
    sequential steps of a few small launches each on a card); distances
    are summed in a fixed order (`sq_dist`), so a card picks the CPU's
    points;
  - ball_query keeps the first `nsample` indices within the radius in
    index order (the `nsample` smallest of where(d^2 <= r^2, index, N)),
    misses padded with the first hit.
The per-group MLPs are Dense layers over the channel axis (`mlp{i}`), each
followed by BatchNorm (momentum 0.9, epsilon 1e-5, explicit `train`) and a
relu, then a max over the group. Names are the flax tree's (`sa1`..`sa3`).
`convert_torch_pointnet2_weights` maps the reference's pretrained
pointnet2_cls checkpoint.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.models.blocks import BatchNorm, Dense


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b|^2 over the last (xyz) axis of two broadcastable tensors, the
    squares added in one order, (dx^2 + dy^2) + dz^2, as the JAX package's
    reduction adds them: each step is its own elementwise op, so the CPU
    and a card round alike and pick the same points."""
    d = None
    for k in range(3):
        e = a[..., k] - b[..., k]
        d = e * e if d is None else d + e * e
    return d


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) -> (B, npoint) int64 indices in the order picked, the
    first of them point 0."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    min_d = torch.full((b, n), float("inf"), dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    picked = []
    for _ in range(npoint):
        picked.append(last)
        d = sq_dist(xyz, xyz[rows, last][:, None])
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=-1)
    return torch.stack(picked, dim=1)


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """(B, M, nsample) indices of the first `nsample` points of xyz (B, N, 3)
    within `radius` of each center (B, M, 3), in index order; misses are
    padded with the first hit."""
    n = xyz.shape[1]
    d2 = sq_dist(centers[:, :, None], xyz[:, None])                       # (B, M, N)
    idx = torch.arange(n, dtype=torch.int32, device=xyz.device)
    order = torch.where(d2 <= radius * radius, idx, n)
    order = torch.topk(order, nsample, dim=-1, largest=False, sorted=True).values
    return torch.where(order == n, order[..., :1], order).long()


def gather_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, N, C), idx (B, ...) -> (B, ..., C)."""
    b = torch.arange(feats.shape[0], device=feats.device).view(-1, *[1] * (idx.dim() - 1))
    return feats[b, idx]


class SetAbstraction(nn.Module):
    """One level: sample centroids, group their neighbours (coordinates
    relative to the centroid, then the point features), the shared MLP, a
    max over the group. npoint None groups every point at a zero centroid."""

    def __init__(self, in_features: int, npoint: Optional[int], radius: Optional[float],
                 nsample: Optional[int], mlp: Sequence[int]):
        super().__init__()
        self.npoint, self.radius, self.nsample, self.n_layers = npoint, radius, nsample, len(mlp)
        cin = in_features
        for i, f in enumerate(mlp):
            setattr(self, f"mlp{i}", Dense(cin, f))
            setattr(self, f"bn{i}", BatchNorm(f))
            cin = f

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor],
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.npoint is None:
            grouped = xyz[:, None]
            if feats is not None:
                grouped = torch.cat([grouped, feats[:, None]], dim=-1)
            new_xyz = torch.zeros((xyz.shape[0], 1, 3), dtype=xyz.dtype, device=xyz.device)
        else:
            new_xyz = gather_points(xyz, farthest_point_sample(xyz, self.npoint))
            idx = ball_query(xyz, new_xyz, self.radius, self.nsample)
            grouped = gather_points(xyz, idx) - new_xyz[:, :, None]
            if feats is not None:
                grouped = torch.cat([grouped, gather_points(feats, idx)], dim=-1)
        y = grouped
        for i in range(self.n_layers):
            y = F.relu(getattr(self, f"bn{i}")(getattr(self, f"mlp{i}")(y), train))
        return new_xyz, torch.amax(y, dim=2)


class PointNet2Encoder(nn.Module):
    """pts (B, N, 3 + C): xyz, then C point features -> (B, 1024)."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.sa1 = SetAbstraction(in_channels, 512, 0.2, 32, (64, 64, 128))
        self.sa2 = SetAbstraction(3 + 128, 128, 0.4, 64, (128, 128, 256))
        self.sa3 = SetAbstraction(3 + 256, None, None, None, (256, 512, 1024))

    def forward(self, pts: torch.Tensor, train: bool = False) -> torch.Tensor:
        xyz = pts[..., :3]
        feats = pts[..., 3:] if pts.shape[-1] > 3 else None
        xyz, f = self.sa1(xyz, feats, train)
        xyz, f = self.sa2(xyz, f, train)
        return self.sa3(xyz, f, train)[1][:, 0]


def convert_torch_pointnet2_weights(state_dict: Mapping[str, object]
                                    ) -> Dict[str, torch.Tensor]:
    """The reference's pointnet2_cls checkpoint (sa{i}.mlp_convs.{j}: 1x1
    Conv2d, sa{i}.mlp_bns.{j}: BatchNorm2d; the fc head ignored) -> the
    port's PointNet2Encoder state_dict."""
    def t(k):
        return torch.as_tensor(np.asarray(state_dict[k], np.float32))

    out = {}
    for sa in ("sa1", "sa2", "sa3"):
        for j in range(3):
            conv, bn = f"{sa}.mlp_convs.{j}", f"{sa}.mlp_bns.{j}"
            out[f"{sa}.mlp{j}.weight"] = t(conv + ".weight")[:, :, 0, 0].contiguous()
            out[f"{sa}.mlp{j}.bias"] = t(conv + ".bias")
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                out[f"{sa}.bn{j}.{leaf}"] = t(f"{bn}.{leaf}")
    return out
