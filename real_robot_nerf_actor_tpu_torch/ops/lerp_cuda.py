"""Trilinear corner lerp over corner-expanded gather rows (Triton).

Counterpart of the JAX package's `ops/lerp_pallas.py`: it replaces
`corner_lerp` (the Pallas kernel `_lerp_kernel`). For rows (M, 8C) of a
corner-expanded grid (ops.grid_sample.expand_corners) and the weight-mask
products w (8, M) fp32,

    out[m, c] = sum_k rows[m, k*C + c] * w[k, m],   k = 0..7

accumulated in fp32 as r0*w0 followed by seven fused multiply-adds in
corner order, rounded once to the rows' dtype. The serving kernel
`fused_gather_resnetfc_int8` (csrc/resnetfc_int8.cu) lerps in exactly this
order, so the gather-fused and the unfused serving paths agree bit for bit.
The rows are gathered beforehand by a plain torch index, as the JAX
renderer gathers them outside its kernel.

What bounds it on this card: 16 bytes of bf16 rows and 32 bytes of weights
read and 2 bytes written per output element against 15 flops: memory
(3.35 TB/s on H100 SXM). Design: one program per 64-row block, the eight
64-wide corner slabs loaded as coalesced 128-byte row segments, the
accumulator in registers.

On a CUDA tensor the wrapper launches the Triton kernel; on a CPU tensor it
runs `corner_lerp_plain`. `triton` is imported inside the launching
function only.

Gradient: the CUDA branch is a `torch.autograd.Function` whose backward is
the JAX package's custom VJP (`lerp_pallas._bwd`) in plain PyTorch:
d_rows[m, k*C + c] = w[k, m] * g[m, c] in the rows' dtype, and
d_w[k, m] = sum_c rows[m, k*C + c] * g[m, c] with fp32 sums, in w's dtype.
"""
from __future__ import annotations

import functools

import torch

_BLOCK_M = 64


def corner_lerp_plain(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows (M, 8C), w (8, M) -> (M, C) in rows.dtype: the einsum of the
    JAX package's `_lerp_xla`, fp32 accumulation."""
    m, c8 = rows.shape
    r = rows.reshape(m, 8, c8 // 8).float()
    return torch.einsum("mkc,km->mc", r, w.float()).to(rows.dtype)


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def lerp_kernel(rows_ptr, w_ptr, out_ptr, M, C,
                    BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
        m = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
        c = tl.arange(0, BLOCK_C)
        mmask = m < M
        mask = mmask[:, None] & (c < C)[None, :]
        m64 = m.to(tl.int64)
        base = rows_ptr + m64[:, None] * (8 * C) + c[None, :]
        w0 = tl.load(w_ptr + m, mask=mmask, other=0.0)
        r0 = tl.load(base, mask=mask, other=0.0).to(tl.float32)
        acc = r0 * w0[:, None]
        for k in tl.static_range(1, 8):
            wk = tl.load(w_ptr + k * M + m, mask=mmask, other=0.0)
            rk = tl.load(base + k * C, mask=mask, other=0.0).to(tl.float32)
            acc = tl.fma(rk, wk[:, None], acc)
        tl.store(out_ptr + m64[:, None] * C + c[None, :],
                 acc.to(out_ptr.dtype.element_ty), mask=mask)

    return lerp_kernel


def _check(rows, w):
    if not (rows.is_cuda and w.is_cuda):
        raise ValueError("corner_lerp: rows and w must lie on a CUDA device "
                         f"(got {rows.device}, {w.device})")
    if rows.dtype not in (torch.float32, torch.bfloat16) or w.dtype != torch.float32:
        raise TypeError("corner_lerp: rows float32/bfloat16 and w float32, got "
                        f"{rows.dtype}, {w.dtype}")
    if rows.dim() != 2 or rows.shape[1] % 8 or tuple(w.shape) != (8, rows.shape[0]):
        raise ValueError(f"corner_lerp: bad shapes {tuple(rows.shape)}, {tuple(w.shape)}")
    if not (rows.is_contiguous() and w.is_contiguous()):
        raise ValueError("corner_lerp: rows and w must be contiguous")


def corner_lerp_vjp(rows: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """(d_rows, d_w) of the lerp at (rows, w) for the output gradient g (M,
    C): the JAX package's `_bwd`, fp32 products and sums."""
    m, c8 = rows.shape
    g32 = g.float()
    d_rows = (w.float().T[:, :, None] * g32[:, None, :]).reshape(m, c8).to(rows.dtype)
    d_w = torch.einsum("mkc,mc->km", rows.reshape(m, 8, c8 // 8).float(), g32).to(w.dtype)
    return d_rows, d_w


def _launch(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on checked CUDA inputs; the output."""
    m, c8 = rows.shape
    c = c8 // 8
    out = torch.empty((m, c), dtype=rows.dtype, device=rows.device)
    block_c = max(16, 1 << (c - 1).bit_length())
    with torch.cuda.device(rows.device):
        _kernel()[(-(-m // _BLOCK_M),)](rows, w, out, m, c, BLOCK_M=_BLOCK_M,
                                        BLOCK_C=block_c, num_warps=4)
    corner_lerp.launches += 1
    return out


class CornerLerp(torch.autograd.Function):
    """The kernel's forward (`_launch`) with the JAX VJP as its backward
    (`corner_lerp_vjp`)."""

    @staticmethod
    def forward(ctx, rows, w):
        ctx.save_for_backward(rows, w)
        return _launch(rows, w)

    @staticmethod
    def backward(ctx, g):
        rows, w = ctx.saved_tensors
        return corner_lerp_vjp(rows, w, g)


def corner_lerp(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows: (M, 8C); w: (8, M) fp32 weight-mask products. Returns (M, C)
    in rows.dtype (fp32 accumulation). Differentiable in both."""
    if rows.device.type == "cpu":
        return corner_lerp_plain(rows, w)
    _check(rows, w)
    return CornerLerp.apply(rows, w)


corner_lerp.launches = 0
