"""Ray -> per-sample field expansion for the int8 serving renderer (CUDA C++).

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
2*(6+3F) + 32 + 4 = 84 bytes out per sample against ~120 flops: memory
(3.35 TB/s on H100 SXM), and at the renderer's 65536 samples a call the
launch. Design (`csrc/ray_expand.cu`): a block of 128 threads takes 32
rays x 8 samples, reads its rays and z rows once into shared memory, and
gives each thread a pair of neighbouring rays at one sample, so that every
store of a warp fills whole 64-byte row segments. Every product, quotient,
sum and difference is a separate round-to-nearest intrinsic, so the kernel
computes exactly what `ray_expand_plain` computes with torch's elementwise
ops. The host path is short: the constants are computed once per
(grid_dims, coord_bounds, num_freqs, freq_factor), each output is one
`torch.empty`, and the launch enters no device context where the tensors'
device is current.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
`ray_expand_plain`. `ray_expand.launches` counts launches of
csrc/ray_expand.cu. No backward: the serving
path is not differentiated in the JAX package either, so a CUDA call under
grad mode with an input that requires a gradient raises
(`ops._grad.refuse_grad`).
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from real_robot_nerf_actor_tpu_torch.ops import _build
from real_robot_nerf_actor_tpu_torch.ops._grad import refuse_grad

BN = 256   # callers pad R to a multiple of it (the JAX kernel's block)
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


@functools.lru_cache(maxsize=64)
def launch_consts(grid_dims: Tuple[int, int, int], coord_bounds: Tuple[float, ...],
                  num_freqs: int, freq_factor: float) -> Tuple[tuple, tuple]:
    """The kernel's scalar arguments after the ray count and the sample
    count: ints (D, H, W, num_freqs) and fp32 floats (lo[3], ext[3],
    freq_factor, 2 pi), rounded as `_consts` rounds them (doubling the
    frequency in the kernel is exact)."""
    lo, ext, _ = _consts(coord_bounds, num_freqs, freq_factor)
    ints = tuple(int(v) for v in grid_dims) + (int(num_freqs),)
    floats = tuple(float(v) for v in (*lo, *ext, np.float32(freq_factor),
                                      np.float32(TWO_PI)))
    return ints, floats


def _launch(rays, z_samp, grid_dims, coord_bounds, num_freqs, freq_factor):
    """Check the CUDA inputs, launch the kernel for them, count it."""
    _check(rays, z_samp)
    r, k = z_samp.shape
    ints, floats = launch_consts(tuple(grid_dims), tuple(coord_bounds), num_freqs,
                                 freq_factor)
    dev = rays.device
    aux = torch.empty((6 + 3 * num_freqs, k, r), dtype=torch.bfloat16, device=dev)
    w8 = torch.empty((8, k, r), dtype=torch.float32, device=dev)
    flat = torch.empty((k, r), dtype=torch.int32, device=dev)
    lib = _build.load("ray_expand")
    code = _build.on_device(dev, lambda stream: lib.ray_expand_fwd(
        rays.data_ptr(), z_samp.data_ptr(), aux.data_ptr(), w8.data_ptr(), flat.data_ptr(),
        r, k, *ints, *floats, stream))
    _build.check(lib, code, "ray_expand")
    ray_expand.launches += 1
    return aux, w8, flat


ray_expand.launches = 0   # launches of csrc/ray_expand.cu
