"""Occupancy-based sample compaction for the neural renderer (counterpart
of the JAX package's `ops/occupancy.py`).

1. ray tightening: intersect every ray with the axis-aligned box of the
   occupied cells and shrink its [near, far] to that slab;
2. occupancy-weighted placement: probe a max-pooled + dilated occupancy
   grid at P points along the (tightened) ray and place the per-ray sample
   budget by inverse CDF over (occupancy + floor).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from h100_bench.reference.frozen.ops.sampling import uniform


def max_dilate(grid: torch.Tensor, times: int) -> torch.Tensor:
    """3^3 max filter applied `times` times to a (V, V, V) grid (borders
    see only the cells inside)."""
    for _ in range(times):
        grid = F.max_pool3d(grid[None, None], 3, stride=1, padding=1)[0, 0]
    return grid


def pool_occupancy(occ: torch.Tensor, pool: int = 4, dilate: int = 1
                   ) -> torch.Tensor:
    """Max-pool a (V, V, V) occupancy grid by `pool`, dilate the result by
    `dilate` cells, threshold > 0 -> float {0, 1}."""
    v = occ.shape[-1]
    if v % pool:
        raise ValueError(f"grid size {v} is not a multiple of the pool {pool}")
    vp = v // pool
    p = occ.float().reshape(vp, pool, vp, pool, vp, pool).amax(dim=(1, 3, 5))
    return (max_dilate(p, dilate) > 0.0).float()


def occupied_aabb(occ_pooled: torch.Tensor) -> torch.Tensor:
    """Canonical AABB (2, 3) [lo, hi] of the occupied cells of a pooled
    (Vp, Vp, Vp) grid (cell outer edges). An empty grid gives the full box."""
    vp = occ_pooled.shape[0]
    out = []
    for ax in range(3):
        v = occ_pooled.amax(dim=tuple(a for a in range(3) if a != ax))
        any_occ = v.max() > 0.0
        lo = torch.argmax(v)
        hi = vp - torch.argmax(v.flip(0))
        lo = torch.where(any_occ, lo, torch.zeros_like(lo))
        hi = torch.where(any_occ, hi, torch.full_like(hi, vp))
        out.append(torch.stack([lo.float() / vp, hi.float() / vp]))
    return torch.stack(out, dim=-1)


def tighten_rays(rays: torch.Tensor, aabb: torch.Tensor,
                 coord_bounds: torch.Tensor) -> torch.Tensor:
    """Shrink each ray's [near, far] to its intersection with the occupied
    AABB (slab method). rays: (R, 8); aabb: (2, 3) canonical; coord_bounds:
    (6,). Rays missing the box get near = far = the original far."""
    bmin, bmax = coord_bounds[:3], coord_bounds[3:]
    w_lo = bmin + aabb[0] * (bmax - bmin)
    w_hi = bmin + aabb[1] * (bmax - bmin)
    o, d = rays[:, :3], rays[:, 3:6]
    near, far = rays[:, 6], rays[:, 7]
    safe_d = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    t0 = (w_lo - o) / safe_d
    t1 = (w_hi - o) / safe_d
    tn = torch.maximum(torch.minimum(t0, t1).amax(dim=-1), near)
    tf = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), far)
    miss = tn >= tf
    tn = torch.where(miss, far, tn)
    tf = torch.where(miss, far, tf)
    return torch.cat([rays[:, :6], tn[:, None], tf[:, None]], dim=-1)


def sample_occupancy(rays: torch.Tensor, occ_pooled: torch.Tensor,
                     n_samples: int, coord_bounds: torch.Tensor,
                     n_probe: int = 32, floor: float = 0.002,
                     u: Optional[torch.Tensor] = None,
                     jitter: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Place `n_samples` z per ray by inverse-CDF over probed occupancy
    (+ floor), stratified within the chosen probe bins. Returns (R, K) z,
    sorted. u, jitter: (R, K) uniform draws."""
    r = rays.shape[0]
    vp = occ_pooled.shape[0]
    near, far = rays[:, 6:7], rays[:, 7:8]
    bmin = coord_bounds[:3]
    inv_span = 1.0 / (coord_bounds[3:] - bmin)
    t_mid = near + (torch.arange(n_probe, dtype=rays.dtype, device=rays.device)[None]
                    + 0.5) / n_probe * (far - near)
    pts = rays[:, None, :3] + t_mid[..., None] * rays[:, None, 3:6]
    canon = (pts - bmin) * inv_span
    cell = torch.clamp((canon * vp).to(torch.int32), 0, vp - 1).long()
    inb = ((canon >= 0.0) & (canon < 1.0)).all(dim=-1)
    flat = (cell[..., 0] * vp + cell[..., 1]) * vp + cell[..., 2]
    occ = occ_pooled.reshape(-1)[flat.reshape(-1)].reshape(r, n_probe)
    w = occ * inb.to(occ.dtype) + floor
    pdf = w / w.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    u = (torch.arange(n_samples, dtype=rays.dtype, device=rays.device)[None]
         + uniform((r, n_samples), rays, u, generator)) / n_samples
    inds = (cdf[:, None, :] <= u[:, :, None]).sum(dim=-1)
    inds = torch.clamp(inds.to(rays.dtype) - 1.0, 0.0, n_probe - 1.0)
    z_steps = (inds + uniform((r, n_samples), rays, jitter, generator)) / n_probe
    z = near + z_steps * (far - near)
    return torch.sort(z, dim=-1).values
