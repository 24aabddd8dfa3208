"""3-D spatial-softmax statistics in one streaming pass (Triton).

Counterpart of the JAX package's `ops/stats_pallas.py`: it replaces
`spatial_stats_3d` (the Pallas kernel `_stats_kernel`). For a cubic volume
(B, V, V, V, C) and e = exp((x - max_c) / T) in fp32 it returns (B, C, 4)
fp32 sums [sum e, sum e*lin[y], sum e*lin[z], sum e*lin[x]] at (z, y, x),
lin[i] = i * 2/(V-1) - 1: the reference's meshgrid('xy') order, so the
keypoints num/den equal `ops.spatial_softmax.spatial_softmax_3d`.

What bounds it on this card: it reads the volume once (256 MB for the
policy's fp32 100^3 x 64 d0) and does ~10 flops per element, far below the
card's balance point: memory (3.35 TB/s on H100 SXM) is the limit.

Design: a pure reduction, written in Triton. Each program owns one
(batch, slab of rows, channel block): it streams its rows in (64 x 64)
tiles, computes the exponentials in registers and keeps four fp32 vectors
of partial sums, so nothing but the partials (B, slabs, 4, C) is written.
A small torch sum folds the slabs, as the JAX wrapper folds its grid
partials. The per-channel max is taken before the kernel, as in JAX.

On a CUDA tensor the wrapper launches the Triton kernel; on a CPU tensor it
runs `spatial_stats_3d_plain`, the same arithmetic in plain PyTorch.
`triton` is imported inside the launching function only.
"""
from __future__ import annotations

import functools

import torch

_BLOCK_R = 64           # rows per tile
_BLOCK_C = 64           # channels per program
_ROWS_PER_PROG = 2048   # rows per slab (a multiple of _BLOCK_R)


def spatial_stats_3d_plain(feature: torch.Tensor,
                           temperature: float = 0.01) -> torch.Tensor:
    """(B, V, V, V, C) -> (B, C, 4) fp32, the kernel's arithmetic."""
    b, v, _, _, c = feature.shape
    mx = torch.amax(feature, dim=(1, 2, 3)).float()
    e = torch.exp((feature.float() - mx[:, None, None, None, :])
                  * (1.0 / temperature))
    lin = torch.arange(v, dtype=torch.float32, device=feature.device) \
        * (2.0 / (v - 1)) - 1.0
    s0 = e.sum(dim=(1, 2, 3))
    sy = torch.einsum("byc,y->bc", e.sum(dim=(1, 3)), lin)
    sz = torch.einsum("bzc,z->bc", e.sum(dim=(2, 3)), lin)
    sx = torch.einsum("bxc,x->bc", e.sum(dim=(1, 2)), lin)
    return torch.stack([s0, sy, sz, sx], dim=-1)


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def stats_kernel(x_ptr, mx_ptr, out_ptr, n_rows, C, V, n_slabs,
                     rows_per_prog, inv_temp, step,
                     BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        b = pid // n_slabs
        slab = pid % n_slabs
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        mx = tl.load(mx_ptr + b * C + cols, mask=cmask, other=0.0)
        s0 = tl.zeros([BLOCK_C], dtype=tl.float32)
        sy = tl.zeros([BLOCK_C], dtype=tl.float32)
        sz = tl.zeros([BLOCK_C], dtype=tl.float32)
        sx = tl.zeros([BLOCK_C], dtype=tl.float32)
        row0 = slab * rows_per_prog
        row_end = tl.minimum(row0 + rows_per_prog, n_rows)
        base = x_ptr + b.to(tl.int64) * n_rows * C
        for r0 in range(row0, row_end, BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            rmask = rows < row_end
            mask = rmask[:, None] & cmask[None, :]
            x = tl.load(base + rows.to(tl.int64)[:, None] * C + cols[None, :],
                        mask=mask, other=0.0).to(tl.float32)
            e = tl.exp((x - mx[None, :]) * inv_temp)
            e = tl.where(mask, e, 0.0)
            zi = rows // (V * V)
            yi = (rows // V) % V
            xi = rows % V
            ly = yi.to(tl.float32) * step - 1.0
            lz = zi.to(tl.float32) * step - 1.0
            lx = xi.to(tl.float32) * step - 1.0
            s0 += tl.sum(e, axis=0)
            sy += tl.sum(e * ly[:, None], axis=0)
            sz += tl.sum(e * lz[:, None], axis=0)
            sx += tl.sum(e * lx[:, None], axis=0)
        out = out_ptr + pid * 4 * C + cols
        tl.store(out, s0, mask=cmask)
        tl.store(out + C, sy, mask=cmask)
        tl.store(out + 2 * C, sz, mask=cmask)
        tl.store(out + 3 * C, sx, mask=cmask)

    return stats_kernel


def _check(feature):
    if not feature.is_cuda:
        raise ValueError(f"spatial_stats_3d: need a CUDA tensor, got {feature.device}")
    if feature.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"spatial_stats_3d: float32 or bfloat16, got {feature.dtype}")
    if feature.dim() != 5 or not (feature.shape[1] == feature.shape[2]
                                  == feature.shape[3]):
        raise ValueError("spatial_stats_3d: need a cubic (B, V, V, V, C) "
                         f"volume, got {tuple(feature.shape)}")
    if not feature.is_contiguous():
        raise ValueError("spatial_stats_3d: feature must be contiguous")


def spatial_stats_3d(feature: torch.Tensor,
                     temperature: float = 0.01) -> torch.Tensor:
    """feature: (B, V, V, V, C) bf16/f32 -> (B, C, 4) fp32 sums
    [denominator, lin[y], lin[z], lin[x] numerators]."""
    if feature.device.type == "cpu":
        return spatial_stats_3d_plain(feature, temperature)
    _check(feature)
    b, v, _, _, c = feature.shape
    n_rows = v * v * v
    n_slabs = -(-n_rows // _ROWS_PER_PROG)
    mx = torch.amax(feature, dim=(1, 2, 3)).float().contiguous()
    partials = torch.empty((b * n_slabs, 4, c), dtype=torch.float32,
                           device=feature.device)
    grid = (b * n_slabs, -(-c // _BLOCK_C))
    with torch.cuda.device(feature.device):
        _kernel()[grid](feature, mx, partials, n_rows, c, v, n_slabs,
                        _ROWS_PER_PROG, 1.0 / temperature, 2.0 / (v - 1),
                        BLOCK_R=_BLOCK_R, BLOCK_C=_BLOCK_C, num_warps=4)
    spatial_stats_3d.launches += 1
    return partials.reshape(b, n_slabs, 4, c).sum(dim=1).transpose(1, 2)


spatial_stats_3d.launches = 0


def spatial_softmax_3d_pallas(feature: torch.Tensor,
                              temperature: float = 0.01) -> torch.Tensor:
    """Drop-in for ops.spatial_softmax.spatial_softmax_3d on cubic volumes,
    through `spatial_stats_3d` (the name keeps the JAX knob's)."""
    b, _, _, _, c = feature.shape
    sums = spatial_stats_3d(feature, temperature)
    kp = sums[..., 1:] / sums[..., :1]
    return kp.reshape(b, c * 3)
