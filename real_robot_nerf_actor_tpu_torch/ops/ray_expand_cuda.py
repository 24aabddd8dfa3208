"""Ray -> per-sample field expansion for the int8 serving renderer (Triton).

Counterpart of the JAX package's `ops/ray_expand_pallas.py`: it replaces
`ray_expand` (the Pallas kernel `_kernel`). For rays (R, 8) [o, d, near,
far] and depths z (R, K), in K-major sample order (n = k*R + r), it emits

    auxT  (6 + 3F, K, R) bf16  [canon(3) | dirs(3) | wrapped phases(3F)]
    w8T   (8, K, R)      f32   lerp weight x in-bounds mask of each corner
    flatT (K, R)         i32   base row in the corner-expanded (+1-padded) grid

canon = (o + z*d - lo) / ext; grid coords canon * (size - 1), with
canon[0] indexing W (torch convention); the base index is clipped to
[-1, size-1] and shifted by +1 into the expanded grid; corner c = dz*4 +
dy*2 + dx carries w = wz*wy*wx*inb. Phases canon*freq_factor*2^f are
wrapped as t - 2*pi*round(t / 2*pi) in fp32 (round half to even) before
the bf16 cast. The arithmetic is ops.grid_sample.grid_sample_3d_fused's
and ops.resnetfc_cuda.pack_mlp_input's.

What bounds it on this card: 32 bytes of rays per ray and 4 bytes of z in,
2*(6+3F) + 32 + 4 = 84 bytes out per sample against ~100 flops: memory
(3.35 TB/s on H100 SXM). Design: one program per (256-ray block, sample
k), every output a contiguous 256-wide row segment. Products and quotients
use round-to-nearest intrinsics (no fused multiply-add, no approximate
division), so the kernel computes exactly what `ray_expand_plain` computes
with torch's elementwise ops.

On a CUDA tensor the wrapper launches the Triton kernel; on a CPU tensor it
runs `ray_expand_plain`. `triton` is imported inside the launching
function only. No backward: the serving path is not differentiated in the
JAX package either, so a CUDA call under grad mode with an input that
requires a gradient raises (`ops._grad.refuse_grad`).
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from real_robot_nerf_actor_tpu_torch.ops._grad import refuse_grad

BN = 256   # rays per program; callers pad R to a multiple of it
TWO_PI = 2.0 * math.pi


def _consts(coord_bounds, num_freqs, freq_factor):
    """The fp32 constants of the arithmetic, rounded as the JAX kernel
    rounds its Python floats: lo, ext = hi - lo (in double first), and the
    per-frequency factors."""
    b = [float(x) for x in coord_bounds]
    lo = [np.float32(b[i]) for i in range(3)]
    ext = [np.float32(b[3 + i] - b[i]) for i in range(3)]
    fr = [np.float32(freq_factor * (2.0 ** f)) for f in range(num_freqs)]
    return lo, ext, fr


def ray_expand_plain(rays: torch.Tensor, z_samp: torch.Tensor,
                     grid_dims: Sequence[int], coord_bounds: Sequence[float],
                     num_freqs: int = 6, freq_factor: float = 1.5
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in torch elementwise ops (constants as 0-d
    tensors, so every quotient is a true fp32 division)."""
    d, h, w = grid_dims
    lo, ext, fr = _consts(coord_bounds, num_freqs, freq_factor)
    dev = rays.device

    def c32(x):
        return torch.tensor(float(x), dtype=torch.float32, device=dev)

    z = z_samp.float().T                                   # (K, R)
    raysT = rays[:, :8].float().T                          # (8, R)
    canon = [(raysT[i][None] + z * raysT[3 + i][None] - c32(lo[i])) / c32(ext[i])
             for i in range(3)]
    gx, gy, gz = (canon[0] * c32(w - 1), canon[1] * c32(h - 1),
                  canon[2] * c32(d - 1))
    x0, y0, z0 = torch.floor(gx), torch.floor(gy), torch.floor(gz)
    tx, ty, tz = gx - x0, gy - y0, gz - z0
    x0i, y0i, z0i = x0.to(torch.int32), y0.to(torch.int32), z0.to(torch.int32)
    wxs, wys, wzs = (1.0 - tx, tx), (1.0 - ty, ty), (1.0 - tz, tz)
    w8 = []
    for k in range(8):
        dz, dy, dx = k >> 2, (k >> 1) & 1, k & 1
        zi, yi, xi = z0i + dz, y0i + dy, x0i + dx
        inb = ((zi >= 0) & (zi < d) & (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))
        w8.append(wzs[dz] * wys[dy] * wxs[dx] * inb.float())
    flat = ((torch.clamp(z0i, -1, d - 1) + 1) * (h + 1)
            + torch.clamp(y0i, -1, h - 1) + 1) * (w + 1) + torch.clamp(x0i, -1, w - 1) + 1
    two_pi = c32(np.float32(TWO_PI))
    aux = [canon[i] for i in range(3)]
    aux += [raysT[3 + i][None].expand_as(z) for i in range(3)]
    for f in range(num_freqs):
        for i in range(3):
            t = canon[i] * c32(fr[f])
            aux.append(t - two_pi * torch.round(t / two_pi))
    return (torch.stack(aux).to(torch.bfloat16), torch.stack(w8),
            flat.to(torch.int32))


def _libdevice():
    try:
        import triton.language.extra.libdevice as ld
    except ImportError:
        import triton.language.extra.cuda.libdevice as ld
    return ld


@functools.cache
def _kernel():
    import triton
    import triton.language as tl
    ld = _libdevice()

    @triton.jit
    def expand_kernel(rays_ptr, z_ptr, aux_ptr, w8_ptr, flat_ptr, R, K,
                      D, H, W, lo0, lo1, lo2, ext0, ext1, ext2, freq_factor,
                      two_pi, NUM_FREQS: tl.constexpr, BLOCK: tl.constexpr):
        r = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        k = tl.program_id(1)
        mask = r < R
        zz = tl.load(z_ptr + r * K + k, mask=mask, other=0.0)
        out = k * R + r                       # offset within one (K, R) plane
        plane = K * R
        # canon and the three per-axis coordinates, each axis on its own
        ox = tl.load(rays_ptr + r * 8 + 0, mask=mask, other=0.0)
        oy = tl.load(rays_ptr + r * 8 + 1, mask=mask, other=0.0)
        oz = tl.load(rays_ptr + r * 8 + 2, mask=mask, other=0.0)
        dx_ = tl.load(rays_ptr + r * 8 + 3, mask=mask, other=0.0)
        dy_ = tl.load(rays_ptr + r * 8 + 4, mask=mask, other=0.0)
        dz_ = tl.load(rays_ptr + r * 8 + 5, mask=mask, other=0.0)
        c0 = ld.div_rn((ox + ld.mul_rn(zz, dx_)) - lo0, ext0)
        c1 = ld.div_rn((oy + ld.mul_rn(zz, dy_)) - lo1, ext1)
        c2 = ld.div_rn((oz + ld.mul_rn(zz, dz_)) - lo2, ext2)
        gx = ld.mul_rn(c0, (W - 1).to(tl.float32))
        gy = ld.mul_rn(c1, (H - 1).to(tl.float32))
        gz = ld.mul_rn(c2, (D - 1).to(tl.float32))
        x0 = tl.floor(gx)
        y0 = tl.floor(gy)
        z0 = tl.floor(gz)
        tx = gx - x0
        ty = gy - y0
        tz = gz - z0
        x0i = x0.to(tl.int32)
        y0i = y0.to(tl.int32)
        z0i = z0.to(tl.int32)
        for c in tl.static_range(8):
            ddz = c >> 2
            ddy = (c >> 1) & 1
            ddx = c & 1
            zi = z0i + ddz
            yi = y0i + ddy
            xi = x0i + ddx
            inb = (zi >= 0) & (zi < D) & (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            wz = tz if ddz == 1 else 1.0 - tz
            wy = ty if ddy == 1 else 1.0 - ty
            wx = tx if ddx == 1 else 1.0 - tx
            wk = ld.mul_rn(ld.mul_rn(ld.mul_rn(wz, wy), wx), inb.to(tl.float32))
            tl.store(w8_ptr + c * plane + out, wk, mask=mask)
        xc = tl.minimum(tl.maximum(x0i, -1), W - 1) + 1
        yc = tl.minimum(tl.maximum(y0i, -1), H - 1) + 1
        zc = tl.minimum(tl.maximum(z0i, -1), D - 1) + 1
        tl.store(flat_ptr + out, (zc * (H + 1) + yc) * (W + 1) + xc, mask=mask)
        tl.store(aux_ptr + 0 * plane + out, c0.to(tl.bfloat16), mask=mask)
        tl.store(aux_ptr + 1 * plane + out, c1.to(tl.bfloat16), mask=mask)
        tl.store(aux_ptr + 2 * plane + out, c2.to(tl.bfloat16), mask=mask)
        tl.store(aux_ptr + 3 * plane + out, dx_.to(tl.bfloat16), mask=mask)
        tl.store(aux_ptr + 4 * plane + out, dy_.to(tl.bfloat16), mask=mask)
        tl.store(aux_ptr + 5 * plane + out, dz_.to(tl.bfloat16), mask=mask)
        fr = freq_factor
        for f in tl.static_range(NUM_FREQS):
            t0 = ld.mul_rn(c0, fr)
            t1 = ld.mul_rn(c1, fr)
            t2 = ld.mul_rn(c2, fr)
            t0 = t0 - ld.mul_rn(two_pi, ld.rint(ld.div_rn(t0, two_pi)))
            t1 = t1 - ld.mul_rn(two_pi, ld.rint(ld.div_rn(t1, two_pi)))
            t2 = t2 - ld.mul_rn(two_pi, ld.rint(ld.div_rn(t2, two_pi)))
            tl.store(aux_ptr + (6 + 3 * f) * plane + out, t0.to(tl.bfloat16), mask=mask)
            tl.store(aux_ptr + (7 + 3 * f) * plane + out, t1.to(tl.bfloat16), mask=mask)
            tl.store(aux_ptr + (8 + 3 * f) * plane + out, t2.to(tl.bfloat16), mask=mask)
            fr = fr * 2.0

    return expand_kernel


def _check(rays, z_samp):
    if not (rays.is_cuda and z_samp.is_cuda):
        raise ValueError("ray_expand: rays and z must lie on a CUDA device "
                         f"(got {rays.device}, {z_samp.device})")
    if rays.dtype != torch.float32 or z_samp.dtype != torch.float32:
        raise TypeError(f"ray_expand: float32 rays and z, got {rays.dtype}, {z_samp.dtype}")
    if rays.dim() != 2 or rays.shape[1] != 8 or z_samp.dim() != 2 \
            or z_samp.shape[0] != rays.shape[0]:
        raise ValueError(f"ray_expand: bad shapes {tuple(rays.shape)}, {tuple(z_samp.shape)}")
    if not (rays.is_contiguous() and z_samp.is_contiguous()):
        raise ValueError("ray_expand: rays and z must be contiguous")


def ray_expand(rays: torch.Tensor, z_samp: torch.Tensor, grid_dims: Sequence[int],
               coord_bounds: Sequence[float], num_freqs: int = 6,
               freq_factor: float = 1.5):
    """rays: (R, 8); z_samp: (R, K); R a multiple of BN (the renderer pads
    by repeating ray 0). Returns (auxT (6+3F, K, R) bf16, w8T (8, K, R)
    f32, flatT (K, R) int32). The block is fixed at BN rays, the value the
    JAX kernel's `bn` argument takes on the serving path."""
    r, k = z_samp.shape
    if r % BN:
        raise ValueError(f"ray_expand: pad the ray batch ({r}) to a multiple of {BN}")
    if rays.device.type == "cpu":
        return ray_expand_plain(rays, z_samp, grid_dims, coord_bounds, num_freqs,
                                freq_factor)
    refuse_grad("ray_expand", 'field.mlp_backend="xla"', rays, z_samp)
    return _launch(rays, z_samp, grid_dims, coord_bounds, num_freqs, freq_factor)


def _launch(rays, z_samp, grid_dims, coord_bounds, num_freqs, freq_factor):
    """Check the CUDA inputs, launch the kernel for them, count it."""
    _check(rays, z_samp)
    r, k = z_samp.shape
    d, h, w = (int(v) for v in grid_dims)
    lo, ext, fr = _consts(coord_bounds, num_freqs, freq_factor)
    dev = rays.device
    aux = torch.empty((6 + 3 * num_freqs, k, r), dtype=torch.bfloat16, device=dev)
    w8 = torch.empty((8, k, r), dtype=torch.float32, device=dev)
    flat = torch.empty((k, r), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _kernel()[(r // BN, k)](
            rays, z_samp, aux, w8, flat, r, k, d, h, w,
            float(lo[0]), float(lo[1]), float(lo[2]),
            float(ext[0]), float(ext[1]), float(ext[2]), float(fr[0]),
            float(np.float32(TWO_PI)), NUM_FREQS=num_freqs, BLOCK=BN, num_warps=4)
    ray_expand.launches += 1
    return aux, w8, flat


ray_expand.launches = 0
