"""Building blocks of the voxel policy (counterpart of the JAX package's
`models/blocks.py`, the parts the PerceiverIO policy uses).

Conventions kept from the JAX package:
  - tensors are channel-last (NDHWC) at every module boundary; convs view
    them as NCDHW through a permute, which is free for the channels-last
    memory layout and needs no copy;
  - parameters are fp32; a module with a compute `dtype` casts its input
    and parameters to it, as flax does, and returns that dtype;
  - submodule and parameter names mirror the flax trees (`Dense_0`,
    `Conv_0`, `ConvTranspose_0`, `BatchNorm_0`, `pallas_kernel`, ...), so
    `convert.py` maps a flax tree leaf by leaf;
  - LeakyReLU slope 0.02 in `act_fn`, 0.01 in the UNet cells.

The TPU lowering tricks of the JAX package (`ZDecomposedConv3D`, the
packed conv, `ContractFirstConv3D`'s contraction order) are kept only as
the maths they compute: every conv backend except "pallas" runs the plain
convolution, and "pallas" runs the hand-written k3 kernel
(`ops/conv3d_cuda.py`). BatchNorm takes flax's `train` argument
explicitly (not `nn.Module.training`): train=True normalises with the batch
statistics and updates the running ones, as flax does under
`mutable=["batch_stats"]`; the default runs on the running statistics.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from real_robot_nerf_actor_tpu_torch.ops.conv3d_cuda import conv3d_k3

LRELU_SLOPE = 0.02

# variance-scaling initializer specs: (scale, mode, distribution), as flax's
# nn.initializers.variance_scaling takes them
InitSpec = Tuple[float, str, str]
LECUN_NORMAL: InitSpec = (1.0, "fan_in", "truncated_normal")
XAVIER_UNIFORM: InitSpec = (1.0, "fan_avg", "uniform")


def act_fn(name: Optional[str]):
    if name is None:
        return lambda x: x
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, LRELU_SLOPE)
    if name == "elu":
        return F.elu
    if name == "tanh":
        return torch.tanh
    raise ValueError(f"unknown activation {name!r}")


def init_for(activation: Optional[str]) -> InitSpec:
    """He-uniform for (leaky) relu, xavier-uniform otherwise."""
    if activation is None or activation == "tanh":
        return XAVIER_UNIFORM
    if activation == "lrelu":
        return (2.0 / (1.0 + LRELU_SLOPE ** 2), "fan_in", "uniform")
    if activation == "relu":
        return (2.0, "fan_in", "uniform")
    raise ValueError(f"unknown activation {activation!r}")


@torch.no_grad()
def variance_scaling_(w: torch.Tensor, spec: InitSpec, fan_in: int,
                      fan_out: int, generator: Optional[torch.Generator] = None):
    scale, mode, dist = spec
    fan = {"fan_in": fan_in, "fan_out": fan_out,
           "fan_avg": (fan_in + fan_out) / 2.0}[mode]
    var = scale / max(1.0, fan)
    if dist == "uniform":
        lim = math.sqrt(3.0 * var)
        w.uniform_(-lim, lim, generator=generator)
    elif dist == "normal":
        w.normal_(0.0, math.sqrt(var), generator=generator)
    elif dist == "truncated_normal":
        # flax: stddev of a normal truncated at +-2 sigma, corrected
        std = math.sqrt(var) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
    else:
        raise ValueError(f"unknown distribution {dist!r}")


def _dtype_for(x: torch.Tensor, w: torch.Tensor, dtype: Optional[torch.dtype]):
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


def edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate-pad the three spatial axes of an NDHWC tensor."""
    for dim in (1, 2, 3):
        n = x.shape[dim]
        idx = torch.arange(-pad, n + pad, device=x.device).clamp(0, n - 1)
        x = x.index_select(dim, idx)
    return x


class Dense(nn.Module):
    """flax nn.Dense: x @ W^T + b; weight (out, in) in torch's layout."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 kernel_init: InitSpec = LECUN_NORMAL,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_init = kernel_init
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator=None):
        out_f, in_f = self.weight.shape
        variance_scaling_(self.weight, self.kernel_init, in_f, out_f, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = _dtype_for(x, self.weight, self.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv3d(nn.Module):
    """flax nn.Conv over NDHWC; weight (out, in, k, k, k) in torch's layout.
    Stride and padding are arguments of the call, as the blocks choose them."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 use_bias: bool = True, kernel_init: InitSpec = LECUN_NORMAL,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_init = kernel_init
        self.dtype = dtype
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k, k))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator=None):
        o, i, k = self.weight.shape[:3]
        variance_scaling_(self.weight, self.kernel_init, i * k ** 3,
                          o * k ** 3, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, stride: int = 1, padding: int = 0):
        dt = _dtype_for(x, self.weight, self.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv3d(x.to(dt).permute(0, 4, 1, 2, 3), self.weight.to(dt), b,
                     stride=stride, padding=padding)
        return y.permute(0, 2, 3, 4, 1)


class ConvTranspose3d(nn.Module):
    """flax nn.ConvTranspose with VALID padding, as torch computes it: weight
    (in, out, k, k, k) holds the flax kernel flipped (convert.py does the
    flip), and the output has (n-1)*s + k cells."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int, use_bias: bool = True,
                 kernel_init: InitSpec = LECUN_NORMAL,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_init = kernel_init
        self.dtype = dtype
        self.stride = stride
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(in_features, features, k, k, k))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator=None):
        i, o, k = self.weight.shape[:3]
        variance_scaling_(self.weight, self.kernel_init, i * k ** 3,
                          o * k ** 3, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = _dtype_for(x, self.weight, self.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv_transpose3d(x.to(dt).permute(0, 4, 1, 2, 3),
                               self.weight.to(dt), b, stride=self.stride)
        return y.permute(0, 2, 3, 4, 1)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over the last axis (epsilon 1e-5; momentum 0.9 as
    the policy's blocks set it, or flax's default 0.99 as the 2-D encoder
    leaves it).

    forward(x, train=False) normalises with the running statistics.
    forward(x, train=True) normalises with the batch's, over every axis but
    the last, computed in fp32 (float64 for a float64 input) as flax
    computes them: mean = E[x] and the biased variance max(0, E[x^2] -
    E[x]^2), the gradient flowing through both; then y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias, and the running statistics become
    m * running + (1 - m) * batch (flax's momentum m; torch's is its
    complement, and `F.batch_norm` would update with the unbiased
    variance).

    `train_statistics_` makes the running statistics trainable leaves, as
    the JAX package's BC fine-tune differentiates and Adam-steps its
    `batch_stats`: forward(x, train=False) then computes flax's inference
    arithmetic, y = (x - mean) * (rsqrt(var + eps) * scale) + bias, with the
    gradient flowing into the mean and the variance."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, train: bool = False):
        if not train and self.running_mean.requires_grad:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (x - self.running_mean) * mul + self.bias
        if not train:
            y = F.batch_norm(x.movedim(-1, 1), self.running_mean, self.running_var,
                             self.weight, self.bias, training=False, eps=self.eps)
            return y.movedim(1, -1)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=dims)
        var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


def train_statistics_(module: nn.Module):
    """Make the running mean and variance of every BatchNorm in `module`
    trainable leaves (requires_grad, still buffers: the state_dict keeps
    their names). Returns them as (name, tensor) pairs, for an optimizer."""
    out = []
    for name, m in module.named_modules():
        if isinstance(m, BatchNorm):
            for leaf in ("running_mean", "running_var"):
                t = getattr(m, leaf).requires_grad_(True)
                out.append((f"{name}.{leaf}" if name else leaf, t))
    return out


class DenseBlock(nn.Module):
    def __init__(self, in_features: int, features: int,
                 activation: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.Dense_0 = Dense(in_features, features,
                             kernel_init=init_for(activation), dtype=dtype)

    def forward(self, x):
        return act_fn(self.activation)(self.Dense_0(x))


class Conv3DBlock(nn.Module):
    """3-D conv + activation. backend "pallas" with k3 / s1 / zero padding
    runs the hand-written k3 kernel on parameters `pallas_kernel`
    (3,3,3,Cin,Cout, the flax layout) and `pallas_bias`; every other
    backend ("xla", "conv2d", "conv2d_packed") is the plain conv on
    `Conv_0`. padding "replicate" pads by edge values, "zeros" by zeros."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, activation: Optional[str] = None,
                 dtype: torch.dtype = torch.float32,
                 padding: str = "replicate", backend: str = "xla"):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.activation, self.dtype, self.padding = activation, dtype, padding
        self.use_kernel = (backend == "pallas" and kernel_size == 3
                           and stride == 1 and padding == "zeros")
        if self.use_kernel:
            self.pallas_kernel = nn.Parameter(
                torch.empty(3, 3, 3, in_features, features))
            self.pallas_bias = nn.Parameter(torch.zeros(features))
        else:
            self.Conv_0 = Conv3d(in_features, features, kernel_size,
                                 kernel_init=init_for(activation), dtype=dtype)

    def reset_parameters(self, generator=None):
        if self.use_kernel:
            cin, cout = self.pallas_kernel.shape[3:]
            variance_scaling_(self.pallas_kernel, init_for(self.activation),
                              27 * cin, 27 * cout, generator)
            nn.init.zeros_(self.pallas_bias)

    def cast_kernel_(self):
        """Hold the kernel path's weight in the compute dtype, for inference:
        the k3 kernel then takes it as it is on every call."""
        if self.use_kernel:
            self.pallas_kernel.data = self.pallas_kernel.data.to(self.dtype)

    def forward(self, x):
        if self.use_kernel:
            # a no-op after cast_kernel_(), which PolicyServer calls at load
            wk = self.pallas_kernel.to(self.dtype)
            y = conv3d_k3(x.to(self.dtype).contiguous(), wk, self.pallas_bias)
            return act_fn(self.activation)(y)
        pad = self.kernel_size // 2
        if pad > 0 and self.padding == "replicate":
            x = edge_pad(x, pad)
            pad = 0
        y = self.Conv_0(x, stride=self.stride, padding=pad)
        return act_fn(self.activation)(y)


class PatchifyConv3D(nn.Module):
    """Non-overlapping patch conv (kernel == stride) as reshape + Dense; the
    Dense rows are ordered (dz, dy, dx, c)."""

    def __init__(self, in_channels: int, features: int, patch: int = 5,
                 activation: Optional[str] = "lrelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch, self.activation = patch, activation
        self.Dense_0 = Dense(patch ** 3 * in_channels, features,
                             kernel_init=init_for(activation), dtype=dtype)

    def forward(self, x):
        b, d, h, w, c = x.shape
        p = self.patch
        if d % p or h % p or w % p:
            raise ValueError(f"volume {(d, h, w)} not divisible by patch {p}")
        x = x.reshape(b, d // p, p, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
            b, d // p, h // p, w // p, p * p * p * c)
        return act_fn(self.activation)(self.Dense_0(x))


class SubpixelUpsample3D(nn.Module):
    """k3 conv at low resolution to factor^3 * features channels, then a
    voxel shuffle to the fine grid."""

    def __init__(self, in_features: int, features: int, factor: int,
                 activation: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features, self.factor, self.activation = features, factor, activation
        self.Conv_0 = Conv3d(in_features, features * factor ** 3, 3,
                             kernel_init=init_for(activation), dtype=dtype)

    def forward(self, x):
        b, d, h, w, _ = x.shape
        f = self.factor
        y = act_fn(self.activation)(self.Conv_0(x, padding=1))
        y = y.reshape(b, d, h, w, f, f, f, self.features)
        y = y.permute(0, 1, 4, 2, 5, 3, 6, 7)
        return y.reshape(b, d * f, h * f, w * f, self.features)


class Conv3DUpsampleBlock(nn.Module):
    """conv -> upsample -> conv. mode "transpose": a stride == kernel
    transposed conv; "subpixel": a low-resolution conv + voxel shuffle;
    "trilinear": the reference's resize + conv."""

    def __init__(self, in_features: int, features: int, stride: int,
                 kernel_size: int = 3, activation: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, mode: str = "subpixel",
                 backend: str = "xla"):
        super().__init__()
        self.stride, self.mode, self.activation = stride, mode, activation
        self.Conv3DBlock_0 = Conv3DBlock(in_features, features, kernel_size, 1,
                                         activation, dtype=dtype, backend=backend)
        if stride > 1 and mode == "subpixel":
            self.SubpixelUpsample3D_0 = SubpixelUpsample3D(
                features, features, stride, activation, dtype)
        elif stride > 1 and mode == "transpose":
            self.ConvTranspose_0 = ConvTranspose3d(
                features, features, stride, stride,
                kernel_init=init_for(activation), dtype=dtype)
        elif stride == 1 or mode == "trilinear":
            self.Conv3DBlock_1 = Conv3DBlock(features, features, kernel_size, 1,
                                             activation, dtype=dtype,
                                             backend=backend)
        else:
            raise ValueError(f"unknown upsample mode {mode!r}")

    def forward(self, x):
        x = self.Conv3DBlock_0(x)
        if self.stride > 1:
            if self.mode == "subpixel":
                return self.SubpixelUpsample3D_0(x)
            if self.mode == "transpose":
                return act_fn(self.activation)(self.ConvTranspose_0(x))
            x = F.interpolate(x.permute(0, 4, 1, 2, 3), scale_factor=self.stride,
                              mode="trilinear", align_corners=False)
            x = x.permute(0, 2, 3, 4, 1)
        return self.Conv3DBlock_1(x)


class ConvBnReLU3D(nn.Module):
    """conv (no bias, zero padding 1) -> batchnorm -> leaky relu (0.01)."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 kernel_size: int = 3):
        super().__init__()
        self.stride = stride
        self.Conv_0 = Conv3d(in_features, features, kernel_size, use_bias=False)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x, train: bool = False):
        x = self.Conv_0(x, stride=self.stride, padding=1)
        return F.leaky_relu(self.BatchNorm_0(x, train), 0.01)


class DeconvBn3D(nn.Module):
    """transposed conv (k3, s2, no bias) -> crop [1:1+out_size] ->
    batchnorm -> leaky relu (0.01); torch ConvTranspose3d(k3, s2, p1,
    output_padding) sizing."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose3d(in_features, features, 3, 2,
                                               use_bias=False)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x, out_size: int, train: bool = False):
        y = self.ConvTranspose_0(x)
        y = y[:, 1:1 + out_size, 1:1 + out_size, 1:1 + out_size]
        return F.leaky_relu(self.BatchNorm_0(y, train), 0.01)


class MultiLayer3DEncoderShallow(nn.Module):
    """3-level 3-D UNet voxel encoder: [8, 16, 32, 64] channels down with
    stride-2 convs, transposed convs up with additive skips, 1x1x1 head."""

    def __init__(self, in_channels: int, features: int = 64):
        super().__init__()
        ch = (8, 16, 32, 64)
        cells = [(in_channels, ch[0], 1), (ch[0], ch[1], 2), (ch[1], ch[1], 1),
                 (ch[1], ch[2], 2), (ch[2], ch[2], 1), (ch[2], ch[3], 2),
                 (ch[3], ch[3], 1)]
        for i, (cin, cout, s) in enumerate(cells):
            setattr(self, f"ConvBnReLU3D_{i}", ConvBnReLU3D(cin, cout, stride=s))
        for i, (cin, cout) in enumerate([(ch[3], ch[2]), (ch[2], ch[1]),
                                         (ch[1], ch[0])]):
            setattr(self, f"DeconvBn3D_{i}", DeconvBn3D(cin, cout))
        self.Conv_0 = Conv3d(ch[0], features, 1)

    def forward(self, x, train: bool = False):
        """train=True: BatchNorm on batch statistics, updating the running
        ones in place (see BatchNorm)."""
        cell = [getattr(self, f"ConvBnReLU3D_{i}") for i in range(7)]
        c0 = cell[0](x, train)
        c2 = cell[2](cell[1](c0, train), train)
        c4 = cell[4](cell[3](c2, train), train)
        c6 = cell[6](cell[5](c4, train), train)
        u = c4 + self.DeconvBn3D_0(c6, c4.shape[1], train)
        u = c2 + self.DeconvBn3D_1(u, c2.shape[1], train)
        u = c0 + self.DeconvBn3D_2(u, c0.shape[1], train)
        return self.Conv_0(u)


class MultiLayer3DEncoder(nn.Module):
    """Deep 4-level 3-D UNet voxel encoder: [32, 64, 128, 256] channels down
    with stride-2 convs (100^3 -> 50 -> 25 -> 13), transposed convs up with
    additive skips, 1x1x1 head. forward returns (out, voxel_list) with
    voxel_list = [input, the V/4 skip sum, the V/2 skip sum]. The cells
    carry flax's numbering: in `cell(down(x))` flax names the outer cell
    first, so ConvBnReLU3D_{1,3,5} are the stride-1 cells and _{2,4,6} the
    stride-2 ones."""

    def __init__(self, in_channels: int, features: int = 64):
        super().__init__()
        ch = (32, 64, 128, 256)
        cells = [(in_channels, ch[0], 1)]
        for lo, hi in zip(ch[:-1], ch[1:]):
            cells += [(hi, hi, 1), (lo, hi, 2)]
        for i, (cin, cout, s) in enumerate(cells):
            setattr(self, f"ConvBnReLU3D_{i}", ConvBnReLU3D(cin, cout, stride=s))
        for i, (cin, cout) in enumerate([(ch[3], ch[2]), (ch[2], ch[1]),
                                         (ch[1], ch[0])]):
            setattr(self, f"DeconvBn3D_{i}", DeconvBn3D(cin, cout))
        self.Conv_0 = Conv3d(ch[0], features, 1)

    def forward(self, x, train: bool = False):
        """train=True: BatchNorm on batch statistics, updating the running
        ones in place (see BatchNorm)."""
        cell = [getattr(self, f"ConvBnReLU3D_{i}") for i in range(7)]
        voxel_list = [x]
        c0 = cell[0](x, train)
        c2 = cell[1](cell[2](c0, train), train)
        c4 = cell[3](cell[4](c2, train), train)
        u = cell[5](cell[6](c4, train), train)
        u = c4 + self.DeconvBn3D_0(u, c4.shape[1], train)
        voxel_list.append(u)
        u = c2 + self.DeconvBn3D_1(u, c2.shape[1], train)
        voxel_list.append(u)
        u = c0 + self.DeconvBn3D_2(u, c0.shape[1], train)
        return self.Conv_0(u), voxel_list


class ContractFirstConv3D(nn.Module):
    """Replicate-padded conv computed channels-first: one matmul
    x @ W (Cin -> taps*Cout), then the 27 shifted taps summed one by one in
    the compute dtype, as the JAX module sums them."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 activation: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size, self.activation, self.dtype = kernel_size, activation, dtype
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k, k))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator=None):
        o, i, k = self.weight.shape[:3]
        variance_scaling_(self.weight, init_for(self.activation), i * k ** 3,
                          o * k ** 3, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        b, d, h, w, cin = x.shape
        k = self.kernel_size
        feats = self.weight.shape[0]
        dt = self.dtype
        w2 = self.weight.permute(1, 2, 3, 4, 0).reshape(cin, k ** 3 * feats)
        t = (x.to(dt) @ w2.to(dt)).reshape(b, d, h, w, k ** 3, feats)
        t = edge_pad(t, k // 2)
        out = torch.zeros((b, d, h, w, feats), dtype=dt, device=x.device)
        for tap in range(k ** 3):
            dz, rem = divmod(tap, k * k)
            dy, dx = divmod(rem, k)
            out = out + t[:, dz:dz + d, dy:dy + h, dx:dx + w, tap]
        out = out + self.bias.to(dt)
        return act_fn(self.activation)(out)


def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None):
    """(Re)initialise every parameter of `module` as flax initialises the
    JAX counterpart, drawing from `generator` in module order."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is None:
            continue
        if isinstance(m, (nn.LayerNorm,)):
            reset()
        else:
            reset(generator)
    return module
