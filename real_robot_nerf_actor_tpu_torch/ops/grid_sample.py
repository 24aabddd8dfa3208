"""Trilinear voxel-grid sampling (torch grid_sample align_corners=True
semantics) on channel-last grids; counterpart of the JAX package's
`ops/grid_sample.py`.

coords[..., 0] indexes the last spatial axis (W), coords[..., 2] the first
(D), as in torch.nn.functional.grid_sample for 5-D inputs.

Gradients reach the grid (not the coordinates: the field detaches them, as
JAX stops their gradient) through autograd of the gathers and lerps; on
the corner-expanded path with FUSED_LERP_BACKEND "pallas" through
`lerp_cuda.corner_lerp` (on CUDA the `CornerLerp` Function, whose backward
is the JAX VJP), then the row index and `expand_corners_to`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# lerp of the corner-expanded path: "nested" (lerp tree, the 8-gather
# path's associativity) or "flat" (sum of corner * weight products)
FUSED_LERP_MODE = "nested"
# "pallas": ops.lerp_cuda.corner_lerp (the Hopper kernel of the JAX
# package's Pallas corner_lerp) on the expanded path
FUSED_LERP_BACKEND = "xla"  # "xla" | "pallas"


def _unnormalize(coords, d, h, w):
    x = (coords[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
    z = (coords[..., 2] + 1.0) * 0.5 * (d - 1)
    return x, y, z


def _inb(zi, yi, xi, d, h, w):
    return (zi >= 0) & (zi < d) & (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid (B, D, H, W, C); coords (B, N, 3) in [-1, 1] -> (B, N, C),
    zero padding outside."""
    b, d, h, w, c = grid.shape
    x, y, z = _unnormalize(coords, d, h, w)
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    tx = (x - x0)[..., None].to(grid.dtype)
    ty = (y - y0)[..., None].to(grid.dtype)
    tz = (z - z0)[..., None].to(grid.dtype)
    x0i, y0i, z0i = x0.to(torch.int32), y0.to(torch.int32), z0.to(torch.int32)
    flat_grid = grid.reshape(b, d * h * w, c)

    def corner(zi, yi, xi):
        inb = _inb(zi, yi, xi, d, h, w)
        flat = ((zi.clamp(0, d - 1) * h + yi.clamp(0, h - 1)) * w
                + xi.clamp(0, w - 1)).long()
        vals = torch.gather(flat_grid, 1, flat[..., None].expand(b, -1, c))
        return vals * inb[..., None].to(grid.dtype)

    c000 = corner(z0i, y0i, x0i)
    c001 = corner(z0i, y0i, x0i + 1)
    c010 = corner(z0i, y0i + 1, x0i)
    c011 = corner(z0i, y0i + 1, x0i + 1)
    c100 = corner(z0i + 1, y0i, x0i)
    c101 = corner(z0i + 1, y0i, x0i + 1)
    c110 = corner(z0i + 1, y0i + 1, x0i)
    c111 = corner(z0i + 1, y0i + 1, x0i + 1)
    c00 = c000 * (1 - tx) + c001 * tx
    c01 = c010 * (1 - tx) + c011 * tx
    c10 = c100 * (1 - tx) + c101 * tx
    c11 = c110 * (1 - tx) + c111 * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def expand_corners(grid: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, D+1, H+1, W+1, 8C): row (i, j, k) holds the
    2x2x2 neighbourhood of base voxel (i-1, j-1, k-1), zero-padded, corner
    block c = dz*4 + dy*2 + dx at channels [c*C, (c+1)*C). One gather row
    per sample instead of eight (about 8x the grid's memory)."""
    b, d, h, w, c = grid.shape
    padded = F.pad(grid, (0, 0, 1, 1, 1, 1, 1, 1))
    return torch.cat([padded[:, dz:dz + d + 1, dy:dy + h + 1, dx:dx + w + 1]
                      for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)], dim=-1)


def _fold_corners(g: torch.Tensor) -> torch.Tensor:
    """The transpose of expand_corners, in fp32: (B, D+1, H+1, W+1, 8C) ->
    (B, D, H, W, C), the eight corner blocks added in their order."""
    b, dp, hp, wp, c8 = g.shape
    c = c8 // 8
    acc = torch.zeros((b, dp + 1, hp + 1, wp + 1, c), dtype=torch.float32,
                      device=g.device)
    for k in range(8):
        dz, dy, dx = k >> 2, (k >> 1) & 1, k & 1
        acc[:, dz:dz + dp, dy:dy + hp, dx:dx + wp] += g[..., k * c:(k + 1) * c]
    return acc[:, 1:-1, 1:-1, 1:-1]


class _ExpandCorners(torch.autograd.Function):
    """expand_corners of the grid cast to `dtype`. The backward adds the
    eight corner blocks of the gradient into one fp32 buffer: JAX expands
    the grid, then casts, so its backward sums them in the grid's fp32."""

    @staticmethod
    def forward(ctx, grid, dtype):
        ctx.in_dtype = grid.dtype
        return expand_corners(grid.to(dtype))

    @staticmethod
    def backward(ctx, g):
        return _fold_corners(g).to(ctx.in_dtype), None


def expand_corners_to(grid: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """expand_corners(grid) in `dtype` (the JAX renderer's
    `expand_corners(grid).astype(dtype)`), cast before the expansion so
    that no expanded copy in the grid's dtype is made."""
    return _ExpandCorners.apply(grid, dtype)


def corner_weights_and_rows(coords: torch.Tensor, d: int, h: int, w: int):
    """Per-sample lerp weights times in-bounds masks, (8, M) fp32 (the
    layout `corner_lerp` takes), and the clipped base row (M,) int64 into
    the corner-expanded (D+1, H+1, W+1) grid. coords: (..., 3), M samples."""
    x, y, z = _unnormalize(coords.reshape(-1, 3).float(), d, h, w)
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    tx, ty, tz = x - x0, y - y0, z - z0
    x0i, y0i, z0i = x0.to(torch.int32), y0.to(torch.int32), z0.to(torch.int32)
    wxs, wys, wzs = (1.0 - tx, tx), (1.0 - ty, ty), (1.0 - tz, tz)
    w8 = torch.stack([
        wzs[k >> 2] * wys[(k >> 1) & 1] * wxs[k & 1]
        * _inb(z0i + (k >> 2), y0i + ((k >> 1) & 1), x0i + (k & 1),
               d, h, w).float() for k in range(8)])
    flat = (((z0i.clamp(-1, d - 1) + 1) * (h + 1) + y0i.clamp(-1, h - 1) + 1)
            * (w + 1) + x0i.clamp(-1, w - 1) + 1)
    return w8, flat.long()


class _FastBwdSample(torch.autograd.Function):
    """grid_sample_3d whose backward reaches the grid through ONE scatter:
    the per-sample rows w8 (x) g, (B, N, 8C) in fp32, go by one `index_add_`
    into the corner-expanded (D+1)(H+1)(W+1) cell space, and the eight
    corner blocks fold back (`_fold_corners`, the transpose of
    expand_corners), cast to the grid's dtype once at the end."""

    @staticmethod
    def forward(ctx, grid, coords):
        ctx.save_for_backward(coords)
        ctx.grid_shape, ctx.grid_dtype = grid.shape, grid.dtype
        return grid_sample_3d(grid, coords)

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        b, d, h, w, c = ctx.grid_shape
        n = coords.shape[1]
        cells = (d + 1) * (h + 1) * (w + 1)
        w8, flat = corner_weights_and_rows(coords, d, h, w)   # (8, B*N), (B*N,)
        rows = (w8.t()[:, :, None] * g.reshape(b * n, 1, c).float()).reshape(b * n, 8 * c)
        flat = (flat.reshape(b, n) + torch.arange(b, device=flat.device)[:, None]
                * cells).reshape(-1)
        d_exp = torch.zeros((b * cells, 8 * c), dtype=torch.float32, device=g.device)
        d_exp.index_add_(0, flat, rows)
        d_grid = _fold_corners(d_exp.reshape(b, d + 1, h + 1, w + 1, 8 * c))
        d_coords = torch.zeros_like(coords) if ctx.needs_input_grad[1] else None
        return d_grid.to(ctx.grid_dtype), d_coords


def grid_sample_3d_fastbwd(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid_sample_3d with a one-scatter backward for the grid gradient
    (see _FastBwdSample). The coords get a zero gradient, as in the JAX
    package: every caller detaches the sample coordinates; use
    grid_sample_3d where d(coords) is needed. Opt-in: the JAX package
    measured it as a net loss at its train step, and nothing on the port's
    main path calls it."""
    return _FastBwdSample.apply(grid, coords)


def grid_sample_3d_fused(expanded: torch.Tensor, coords: torch.Tensor,
                         out_channels: int, backend: "str | None" = None
                         ) -> torch.Tensor:
    """Trilinear sample from a corner-expanded grid with ONE gather row per
    sample; equals grid_sample_3d on the original grid. expanded:
    (B, D+1, H+1, W+1, 8C); coords (B, N, 3) in [-1, 1]; returns (B, N, C)."""
    b, dp, hp, wp, c8 = expanded.shape
    d, h, w = dp - 1, hp - 1, wp - 1
    c = out_channels
    n = coords.shape[1]
    rows_all = expanded.reshape(b, dp * hp * wp, c8)
    if (backend or FUSED_LERP_BACKEND) == "pallas":
        from real_robot_nerf_actor_tpu_torch.ops.lerp_cuda import corner_lerp
        w8, flat = corner_weights_and_rows(coords, d, h, w)
        flat = flat.reshape(b, n) + torch.arange(b, device=flat.device)[:, None] \
            * (dp * hp * wp)
        rows = rows_all.reshape(-1, c8)[flat.reshape(-1)]
        return corner_lerp(rows, w8).reshape(b, n, c)

    x, y, z = _unnormalize(coords, d, h, w)
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    tx = (x - x0)[..., None].to(expanded.dtype)
    ty = (y - y0)[..., None].to(expanded.dtype)
    tz = (z - z0)[..., None].to(expanded.dtype)
    x0i, y0i, z0i = x0.to(torch.int32), y0.to(torch.int32), z0.to(torch.int32)
    flat = (((z0i.clamp(-1, d - 1) + 1) * hp + y0i.clamp(-1, h - 1) + 1) * wp
            + x0i.clamp(-1, w - 1) + 1).long()
    rows = torch.gather(rows_all, 1, flat[..., None].expand(b, n, c8))
    masks = [_inb(z0i + dz, y0i + dy, x0i + dx, d, h, w)[..., None].to(expanded.dtype)
             for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    if FUSED_LERP_MODE == "flat":
        wx, wy, wz = (1 - tx, tx), (1 - ty, ty), (1 - tz, tz)
        out = None
        for k in range(8):
            wk = wz[k >> 2] * wy[(k >> 1) & 1] * wx[k & 1] * masks[k]
            term = rows[..., k * c:(k + 1) * c] * wk
            out = term if out is None else out + term
        return out
    cs = [rows[..., k * c:(k + 1) * c] * masks[k] for k in range(8)]
    c00 = cs[0] * (1 - tx) + cs[1] * tx
    c01 = cs[2] * (1 - tx) + cs[3] * tx
    c10 = cs[4] * (1 - tx) + cs[5] * tx
    c11 = cs[6] * (1 - tx) + cs[7] * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def sample_in_canonical_voxel(voxel_feat: torch.Tensor, canon_xyz: torch.Tensor,
                              expanded: bool = False, out_channels: int = 0,
                              backend: "str | None" = None) -> torch.Tensor:
    """Sample a channel-last grid (or its corner-expanded form when
    expanded=True, then out_channels = C) at canonical [0, 1]^3 points
    (B, N, 3). Returns (B, N, C)."""
    coords = canon_xyz * 2.0 - 1.0
    if expanded:
        return grid_sample_3d_fused(voxel_feat, coords, out_channels, backend)
    return grid_sample_3d(voxel_feat, coords)
