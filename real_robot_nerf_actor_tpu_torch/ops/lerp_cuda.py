"""Trilinear corner lerp over corner-expanded gather rows (CUDA C++).

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
(3.35 TB/s on H100 SXM). Design (`csrc/corner_lerp.cu`): one 16-byte chunk
of an output row a thread (8 bf16 or 4 fp32 channels), eight 16-byte loads
of the corners, the sums in fp32 registers, one 16-byte store; rows whose
channels are not whole 16-byte chunks, or a base that is not 16-byte
aligned, take a scalar path (`vector_path` decides). The host path launches
straight from the wrapper where no gradient is wanted.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
`corner_lerp_plain`. `corner_lerp.launches` counts launches of
csrc/corner_lerp.cu, `vjp_calls` backward passes through `CornerLerp`.

Gradient: the CUDA branch is a `torch.autograd.Function` whose backward is
the JAX package's custom VJP (`lerp_pallas._bwd`) in plain PyTorch:
d_rows[m, k*C + c] = w[k, m] * g[m, c] in the rows' dtype, and
d_w[k, m] = sum_c rows[m, k*C + c] * g[m, c] with fp32 sums, in w's dtype.
"""
from __future__ import annotations

import torch

from real_robot_nerf_actor_tpu_torch.ops import _build
from real_robot_nerf_actor_tpu_torch.utils.profiling import named_scope

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def corner_lerp_plain(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows (M, 8C), w (8, M) -> (M, C) in rows.dtype: the einsum of the
    JAX package's `_lerp_xla`, fp32 accumulation."""
    m, c8 = rows.shape
    r = rows.reshape(m, 8, c8 // 8).float()
    return torch.einsum("mkc,km->mc", r, w.float()).to(rows.dtype)


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


def vector_path(rows: torch.Tensor) -> bool:
    """Whether the kernel takes its 16-byte path for these rows: the
    channels of a corner are whole 16-byte chunks and the base is 16-byte
    aligned (the output, a fresh allocation, always is)."""
    c = rows.shape[1] // 8
    return (c * rows.element_size()) % 16 == 0 and rows.data_ptr() % 16 == 0


def _launch(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on checked CUDA inputs; the output."""
    m, c8 = rows.shape
    c = c8 // 8
    out = torch.empty((m, c), dtype=rows.dtype, device=rows.device)
    lib = _build.load("corner_lerp")
    code = _build.on_device(rows.device, lambda stream: lib.corner_lerp_fwd(
        rows.data_ptr(), w.data_ptr(), out.data_ptr(), m, c, _DTYPES[rows.dtype],
        int(vector_path(rows)), stream))
    _build.check(lib, code, "corner_lerp")
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
        corner_lerp.vjp_calls += 1
        with named_scope("backward.corner_lerp"):
            return corner_lerp_vjp(rows, w, g)


def corner_lerp(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows: (M, 8C); w: (8, M) fp32 weight-mask products. Returns (M, C)
    in rows.dtype (fp32 accumulation). Differentiable in both."""
    if rows.device.type == "cpu":
        return corner_lerp_plain(rows, w)
    _check(rows, w)
    if torch.is_grad_enabled() and (rows.requires_grad or w.requires_grad):
        return CornerLerp.apply(rows, w)
    return _launch(rows, w)          # nothing to differentiate: no Function


corner_lerp.launches = 0    # launches of csrc/corner_lerp.cu
corner_lerp.vjp_calls = 0   # backward passes through CornerLerp (corner_lerp_vjp)
