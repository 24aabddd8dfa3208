"""3-D convolution, kernel 3, stride 1, zero padding, NDHWC (forward).

Counterpart of the JAX package's `ops/conv3d_pallas.py`. On a CUDA tensor
`conv3d_k3` launches a hand-written Hopper kernel of `csrc/conv3d_k3.cu`:
bf16 with Cin a multiple of 64 and Cout a multiple of 8 (the policy's
`final` conv, 128 -> 64) goes to the wgmma/TMA implicit GEMM over haloed
bricks (`takes_wgmma`); every other shape and fp32 to the first, SIMT/WMMA
kernel. On a CPU tensor it runs `conv3d_k3_plain`, 27 shifted tap matmuls
with the kernel's arithmetic. A CUDA call neither kernel takes raises.

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
BRICK = (16, 8, 2)   # output voxels (x, y, z) of one item of the wgmma kernel


def halo_bytes(shape, cout: int) -> int:
    """Bytes of x that the wgmma kernel loads for x of `shape` (B, D, H, W,
    Cin): one box of the brick plus its one-voxel halo, 64 channels deep,
    per brick, 64-channel group and 64-wide tile of Cout."""
    b, d, h, w, cin = shape
    bx, by, bz = BRICK
    bricks = b * -(-d // bz) * -(-h // by) * -(-w // bx)
    return bricks * (cin // 64) * -(-cout // 64) * (bx + 2) * (by + 2) * (bz + 2) * 128


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


def takes_wgmma(x: torch.Tensor, kernel: torch.Tensor) -> bool:
    """Whether a (checked) CUDA call runs on the wgmma kernel: bf16, Cin a
    multiple of 64 (whole 128-byte halo rows), Cout a multiple of 8 (16-byte
    weight rows for TMA), 16-byte aligned x and weight."""
    cin, cout = kernel.shape[3], kernel.shape[4]
    return (x.dtype == torch.bfloat16 and cin % 64 == 0 and cout % 8 == 0
            and x.data_ptr() % 16 == 0 and kernel.data_ptr() % 16 == 0)


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
    wgmma = takes_wgmma(x, kernel)
    ptrs = (x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if wgmma:
            code = lib.conv3d_k3_wgmma_fwd(*ptrs, b, d, h, w, cin, cout, stream)
        else:
            code = lib.conv3d_k3_fwd(*ptrs, b, d, h, w, cin, cout, _DTYPES[x.dtype],
                                     stream)
    _build.check(lib, code, "conv3d_k3")
    conv3d_k3.launches += 1
    conv3d_k3.wgmma_launches += wgmma
    return out


conv3d_k3.launches = 0         # calls that launched a kernel (either design)
conv3d_k3.wgmma_launches = 0   # of those, calls of the wgmma/TMA kernel
