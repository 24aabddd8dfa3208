"""Fully-connected ResNet NeRF MLP (counterpart of the JAX package's
`models/resnetfc.py`).

  - Dense_0 (lin_in): d_in -> d_hidden; lin_out: d_hidden -> d_out, kept as
    the raw params `lin_out_kernel` (d_hidden, d_out) / `lin_out_bias`, in
    the flax layout, as the JAX module declares them;
  - n_blocks residual blocks fc0(relu(x)) -> fc1(relu(.)), fc1 zero-init;
  - latent injection x += lin_z_i(z) for blocks before combine_layer;
  - with num_views > 1, the views (adjacent rows) are reduced at block
    combine_layer, by their mean (combine_type "average") or max, and the
    latent is dropped after it.

Module and parameter names are the flax tree's. The port's `quantized`
(W8A8) blocks are left out of this frozen copy, which refuses them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from h100_bench.reference.frozen.models.blocks import Dense

KAIMING = (2.0, "fan_in", "normal")   # flax variance_scaling(2, fan_in, normal)
ZEROS = (0.0, "fan_in", "normal")     # flax initializers.zeros


class ResnetBlockFC(nn.Module):
    def __init__(self, size_in: int, size_out: int, dtype: torch.dtype):
        super().__init__()
        dense = Dense
        self.Dense_0 = dense(size_in, min(size_in, size_out), kernel_init=KAIMING,
                             dtype=dtype)
        self.Dense_1 = dense(min(size_in, size_out), size_out, kernel_init=ZEROS,
                             dtype=dtype)
        if size_in != size_out:
            self.Dense_2 = dense(size_in, size_out, use_bias=False,
                                 kernel_init=KAIMING, dtype=dtype)

    def forward(self, x):
        h = self.Dense_0(F.relu(x))
        dx = self.Dense_1(F.relu(h))
        if hasattr(self, "Dense_2"):
            x = self.Dense_2(x)
        return x + dx


class ResnetFC(nn.Module):
    def __init__(self, d_in: int, d_out: int = 4, n_blocks: int = 5,
                 d_latent: int = 0, d_hidden: int = 512, combine_layer: int = 1000,
                 combine_type: str = "average", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_latent, self.n_blocks, self.combine_layer = d_latent, n_blocks, combine_layer
        self.combine_type = combine_type
        self.dtype = dtype
        self.Dense_0 = Dense(d_in, d_hidden, kernel_init=KAIMING, dtype=dtype)
        if d_latent > 0:
            for i in range(min(combine_layer, n_blocks)):
                setattr(self, f"lin_z_{i}", Dense(d_latent, d_hidden,
                                                  kernel_init=KAIMING, dtype=dtype))
        for i in range(n_blocks):
            setattr(self, f"ResnetBlockFC_{i}", ResnetBlockFC(d_hidden, d_hidden, dtype))
        self.lin_out_kernel = nn.Parameter(torch.empty(d_hidden, d_out))
        self.lin_out_bias = nn.Parameter(torch.zeros(d_out))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            std = math.sqrt(2.0 / self.lin_out_kernel.shape[0])
            self.lin_out_kernel.normal_(0.0, std, generator=generator)
            self.lin_out_bias.zero_()

    def forward(self, zx, num_views: int = 1, ret_last_feat: bool = False,
                head_dims: Optional[int] = None):
        """zx: (..., d_latent + d_in), or a tuple (z, x). Returns (out
        (..., d_out or head_dims), last hidden); with ret_last_feat, out
        carries the last hidden appended. With num_views > 1 the leading axis
        holds num_views adjacent rows a point and shrinks by that factor at
        combine_layer."""
        if isinstance(zx, tuple):
            z, x = zx
            z = None if z is None else z.to(self.dtype)
            x = x.to(self.dtype)
        else:
            zx = zx.to(self.dtype)
            z = zx[..., :self.d_latent] if self.d_latent > 0 else None
            x = zx[..., self.d_latent:]
        x = self.Dense_0(x)
        for blk in range(self.n_blocks):
            if blk == self.combine_layer and num_views > 1:
                x = x.reshape(-1, num_views, *x.shape[1:])
                x = x.mean(dim=1) if self.combine_type == "average" else x.amax(dim=1)
                z = None
            if z is not None and blk < self.combine_layer:
                x = x + getattr(self, f"lin_z_{blk}")(z)
            x = getattr(self, f"ResnetBlockFC_{blk}")(x)
        n = self.lin_out_kernel.shape[1] if head_dims is None else head_dims
        out = (F.relu(x) @ self.lin_out_kernel[:, :n].to(self.dtype)
               + self.lin_out_bias[:n].to(self.dtype))
        if ret_last_feat:
            return torch.cat([out, x], dim=-1), x
        return out, x
