"""IGR-style implicit MLP (SDF-capable), the pixelNeRF family's alternate
field network (counterpart of the JAX package's `models/implicit.py`).

A stack of Dense layers `lin{l}` with input skips (concat with the input,
then / sqrt(2)), softplus(beta) / beta or ReLU between them, the multiview
combine at combine_layer, and the geometric initialisation: the last layer's
first output unit starts as an SDF of a sphere of radius `radius_init`
(negated: inside positive), its other units N(0, output_init_gain^2), the
hidden layers N(0, 2 / fan_out), and the positional-code rows of the input
zeroed at layer 0 and at each skip layer. The draws come from a
`torch.Generator` (`init_weights`), so a seed gives other weights than the
JAX package's key.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.models.blocks import Dense, variance_scaling_

KAIMING = (2.0, "fan_in", "normal")


class _GeometricDense(Dense):
    """A Dense of ImplicitNet, drawn by its layer's rule."""

    def __init__(self, net: "ImplicitNet", layer: int, in_features: int, features: int):
        super().__init__(in_features, features, kernel_init=KAIMING, dtype=net.dtype)
        self.rule = (net.geometric_init, layer == net.n_layers - 1,
                     layer == 0 or layer in net.skip_in, net.d_in - net.num_position_inputs,
                     net.radius_init, net.output_init_gain, net.sdf_scale)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        geometric, last, zero_tail, tail, radius, gain, sdf_scale = self.rule
        w, b = self.weight, self.bias
        out_f, in_f = w.shape
        with torch.no_grad():
            b.zero_()
            if not geometric:
                variance_scaling_(w, KAIMING, in_f, out_f, generator)
                return
            if last:
                w[:1].normal_(0.0, 1.0, generator=generator)
                w[:1].mul_(1e-5).sub_(math.sqrt(math.pi) / math.sqrt(in_f) * sdf_scale)
                w[1:].normal_(0.0, 1.0, generator=generator)
                w[1:].mul_(gain)
                b[0] = radius
            else:
                w.normal_(0.0, math.sqrt(2.0) / math.sqrt(out_f), generator=generator)
            if tail > 0 and zero_tail:
                w[:, -tail:] = 0.0


class ImplicitNet(nn.Module):
    """x (N, d_in) -> (N', d_out); N' = N / num_views after the combine."""

    def __init__(self, d_in: int, dims: Sequence[int], d_out: int = 4,
                 skip_in: Tuple[int, ...] = (), geometric_init: bool = True,
                 radius_init: float = 0.3, beta: float = 0.0, output_init_gain: float = 2.0,
                 num_position_inputs: int = 3, sdf_scale: float = 1.0,
                 combine_layer: int = 1000, combine_type: str = "average",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_in, self.skip_in, self.geometric_init = d_in, tuple(skip_in), geometric_init
        self.radius_init, self.beta, self.output_init_gain = radius_init, beta, output_init_gain
        self.num_position_inputs, self.sdf_scale = num_position_inputs, sdf_scale
        self.combine_layer, self.combine_type, self.dtype = combine_layer, combine_type, dtype
        dims = [d_in] + list(dims) + [d_out]
        self.n_layers = len(dims) - 1
        width = d_in
        for layer in range(self.n_layers):
            if layer < combine_layer and layer in self.skip_in:
                width += d_in
            out_dim = dims[layer + 1] - (d_in if (layer + 1) in self.skip_in else 0)
            setattr(self, f"lin{layer}", _GeometricDense(self, layer, width, out_dim))
            width = out_dim

    def forward(self, x: torch.Tensor, num_views: int = 1) -> torch.Tensor:
        def act(v):
            return F.softplus(self.beta * v) / self.beta if self.beta > 0 else F.relu(v)

        x = x.to(self.dtype)
        x_init = x
        for layer in range(self.n_layers):
            if layer == self.combine_layer and num_views > 1:
                def comb(t):
                    t = t.reshape(-1, num_views, t.shape[-1])
                    return t.mean(dim=1) if self.combine_type == "average" else t.amax(dim=1)
                x, x_init = comb(x), comb(x_init)
                num_views = 1
            if layer < self.combine_layer and layer in self.skip_in:
                x = torch.cat([x, x_init], dim=-1) / math.sqrt(2.0)
            x = getattr(self, f"lin{layer}")(x)
            if layer < self.n_layers - 1:
                x = act(x)
        return x
