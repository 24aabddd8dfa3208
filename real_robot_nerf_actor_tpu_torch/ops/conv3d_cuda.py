"""3-D convolution, kernel 3, stride 1, zero padding, NDHWC (forward).

Counterpart of the JAX package's `ops/conv3d_pallas.py`. On a CUDA tensor
`conv3d_k3` launches the hand-written Hopper kernel of `csrc/conv3d_k3.cu`;
on a CPU tensor it runs `conv3d_k3_plain`, 27 shifted tap matmuls with the
kernel's arithmetic. A CUDA call the kernel cannot take raises.

The weight keeps the flax layout (3, 3, 3, Cin, Cout). The plain version
casts it to the input's dtype as the TPU path does
(`wk = kernel.astype(x.dtype)`); the kernel takes it already in x's dtype,
as given, so a caller casts it once, at load (`Conv3DBlock.cast_kernel_`),
not on every call.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from real_robot_nerf_actor_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def conv3d_k3_plain(x: torch.Tensor, kernel: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """27 tap matmuls over the zero-padded volume; products of the inputs
    (in x's dtype) summed in fp32, fp32 bias, one rounding to x's dtype."""
    b, d, h, w, cin = x.shape
    wk = kernel.to(x.dtype).float()
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)).float()
    acc = torch.zeros((b, d, h, w, kernel.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                acc += xp[:, dz:dz + d, dy:dy + h, dx:dx + w] @ wk[dz, dy, dx]
    if bias is not None:
        acc += bias.float()
    return acc.to(x.dtype)


def _check(x, kernel, bias):
    if not (x.is_cuda and kernel.is_cuda and (bias is None or bias.is_cuda)):
        raise ValueError("conv3d_k3: all inputs must lie on a CUDA device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3d_k3: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5 or kernel.shape[:3] != (3, 3, 3) or kernel.dim() != 5 \
            or kernel.shape[3] != x.shape[4]:
        raise ValueError(f"conv3d_k3: bad shapes x {tuple(x.shape)}, "
                         f"kernel {tuple(kernel.shape)} (want (3,3,3,Cin,Cout))")
    if kernel.dtype != x.dtype:
        raise TypeError(f"conv3d_k3: kernel dtype {kernel.dtype} is not x's "
                        f"{x.dtype}: cast the weight once, at load")
    if bias is not None and (bias.shape != (kernel.shape[4],)
                             or bias.dtype != torch.float32):
        raise ValueError(f"conv3d_k3: bias must be float32 of shape "
                         f"({kernel.shape[4]},), got {bias.dtype} {tuple(bias.shape)}")
    if not (x.is_contiguous() and kernel.is_contiguous()
            and (bias is None or bias.is_contiguous())):
        raise ValueError("conv3d_k3: x, kernel and bias must be contiguous")


def conv3d_k3(x: torch.Tensor, kernel: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, D, H, W, Cin), kernel (3, 3, 3, Cin, Cout) in x's dtype, bias
    (Cout,) fp32 -> (B, D, H, W, Cout) in x's dtype."""
    if x.device.type == "cpu":
        return conv3d_k3_plain(x, kernel, bias)
    _check(x, kernel, bias)
    b, d, h, w, cin = x.shape
    cout = kernel.shape[-1]
    lib = _build.load("conv3d_k3")
    out = torch.empty((b, d, h, w, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.conv3d_k3_fwd(
            x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), b, d, h, w, cin, cout, _DTYPES[x.dtype], stream)
    _build.check(lib, code, "conv3d_k3")
    conv3d_k3.launches += 1
    return out


conv3d_k3.launches = 0
