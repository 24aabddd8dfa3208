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

Gradient: the CUDA branch is a `torch.autograd.Function` whose backward is
the JAX package's custom VJP (`_conv3d_k3_bwd`, the VJP of the plain XLA
conv): dx and dk from the conv's own input and weight gradients (one
`convolution_backward`, cuDNN on the card, every operand channels-last) in
the kernel's dtype, db the fp32 sum of the output gradient over B, D, H
and W. There is no backward kernel: the reference has none either.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from real_robot_nerf_actor_tpu_torch.ops import _build
from real_robot_nerf_actor_tpu_torch.utils.profiling import named_scope

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


def conv3d_k3_vjp(x: torch.Tensor, kernel: torch.Tensor, g: torch.Tensor,
                  needs=(True, True, True)):
    """(dx, dk, db) of the conv at (x, kernel) for the output gradient g, as
    the JAX package's `_conv3d_k3_bwd` computes them: the plain conv's VJP.
    dx (B, D, H, W, Cin) in x's dtype, dk (3, 3, 3, Cin, Cout) in the
    kernel's, db (Cout,) fp32; each None where `needs` says so."""
    g = g.to(x.dtype)
    xn, gn = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
    # the weight in channels-last order as well: cuDNN then keeps every
    # operand in that format and hands dx back as a contiguous NDHWC tensor
    # (from a default-format weight it returns NCDHW, whose NDHWC view every
    # later backward op reads and writes strided)
    wn = kernel.to(x.dtype).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    dx = dk = db = None
    if needs[0] or needs[1]:
        dxn, dkn, _ = torch.ops.aten.convolution_backward(
            gn, xn, wn, None, (1, 1, 1), (1, 1, 1), (1, 1, 1), False, (0, 0, 0), 1,
            (bool(needs[0]), bool(needs[1]), False))
        if needs[0]:
            dx = dxn.permute(0, 2, 3, 4, 1)
        if needs[1]:
            dk = dkn.permute(2, 3, 4, 1, 0).to(kernel.dtype)
    if needs[2]:
        db = g.sum(dim=(0, 1, 2, 3), dtype=torch.float32)
    return dx, dk, db


def _launch(x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of the kernel on checked CUDA inputs; the output."""
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


class Conv3dK3(torch.autograd.Function):
    """The kernel's forward (`_launch`) with the plain conv's VJP as its
    backward (`conv3d_k3_vjp`)."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        return _launch(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        conv3d_k3.vjp_calls += 1
        with named_scope("backward.conv3d_k3"):
            return conv3d_k3_vjp(x, kernel, g, ctx.needs_input_grad)


def conv3d_k3(x: torch.Tensor, kernel: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, D, H, W, Cin), kernel (3, 3, 3, Cin, Cout) in x's dtype, bias
    (Cout,) fp32 -> (B, D, H, W, Cout) in x's dtype. Differentiable in all
    three (see the module's note)."""
    if x.device.type == "cpu":
        return conv3d_k3_plain(x, kernel, bias)
    _check(x, kernel, bias)
    return Conv3dK3.apply(x, kernel, bias)


conv3d_k3.launches = 0         # calls that launched a kernel (either design)
conv3d_k3.wgmma_launches = 0   # of those, calls of the wgmma/TMA kernel
conv3d_k3.vjp_calls = 0        # backward passes through Conv3dK3 (conv3d_k3_vjp)
