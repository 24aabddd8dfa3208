"""Ray-depth samplers: stratified coarse, importance (CDF-inversion) fine,
importance over arbitrary sorted positions, and depth-guided fine
(counterpart of the JAX package's `ops/sampling.py`).

Every sampler takes its random draws as optional tensor arguments (uniform
in [0, 1), or standard normal for `sample_fine_depth`), so a test can feed
both packages the same numbers; when a draw is None it is taken from
`generator` on the generator's device (a CPU generator, as the trainer's,
serves rays on the card) and moved to the rays' device.
"""
from __future__ import annotations

from typing import Optional

import torch


def _drawn(fn, shape, like, generator):
    dev = generator.device if generator is not None else like.device
    return fn(shape, generator=generator, device=dev, dtype=like.dtype).to(like.device)


def uniform(shape, like: torch.Tensor, u: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """`u` as given (checked against `shape`), else fresh U[0, 1) draws."""
    if u is not None:
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"draws of shape {tuple(u.shape)}, want {tuple(shape)}")
        return u.to(device=like.device, dtype=like.dtype)
    return _drawn(torch.rand, shape, like, generator)


def normal(shape, like: torch.Tensor, generator: Optional[torch.Generator] = None
           ) -> torch.Tensor:
    """Fresh N(0, 1) draws of `like`'s dtype on its device."""
    return _drawn(torch.randn, shape, like, generator)


def _lerp_z(rays, z_steps, lindisp):
    near, far = rays[:, -2:-1], rays[:, -1:]
    if not lindisp:
        return near * (1.0 - z_steps) + far * z_steps
    return 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)


def sample_coarse(rays: torch.Tensor, n_coarse: int, lindisp: bool = False,
                  u: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stratified sampling. rays: (B, 8) -> z samples (B, Kc).
    u: (B, Kc) uniform draws."""
    b = rays.shape[0]
    step = 1.0 / n_coarse
    z_steps = torch.linspace(0.0, 1.0 - step, n_coarse, dtype=rays.dtype,
                             device=rays.device)[None]
    z_steps = z_steps + uniform((b, n_coarse), rays, u, generator) * step
    return _lerp_z(rays, z_steps, lindisp)


def _inverse_cdf(w, u):
    """searchsorted(right) of u into the cdf of w, as a compare + count."""
    pdf = w / w.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    return (cdf[:, None, :] <= u[:, :, None]).sum(dim=-1)


def sample_fine(rays: torch.Tensor, weights: torch.Tensor, n_fine: int,
                n_coarse: int, lindisp: bool = False,
                u: Optional[torch.Tensor] = None,
                jitter: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Importance sampling from coarse weights via inverse-CDF.
    rays: (B, 8); weights: (B, Kc). Returns (B, n_fine).
    u, jitter: (B, n_fine) uniform draws."""
    b = rays.shape[0]
    w = weights.detach() + 1e-5
    u = uniform((b, n_fine), rays, u, generator)
    inds = _inverse_cdf(w, u)
    inds = torch.clamp(inds.to(rays.dtype) - 1.0, min=0.0)
    z_steps = (inds + uniform((b, n_fine), rays, jitter, generator)) / n_coarse
    return _lerp_z(rays, z_steps, lindisp)


def sample_importance_z(z: torch.Tensor, weights: torch.Tensor, n_fine: int,
                        u: Optional[torch.Tensor] = None,
                        t: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Importance sampling over ARBITRARY sorted coarse positions: the CDF
    is inverted over the actual intervals [z_i, z_{i+1}], weighted by the
    coarse weights. z: (B, K) sorted; weights: (B, K). Returns (B, n_fine),
    unsorted. u, t: (B, n_fine) uniform draws."""
    b, k = z.shape
    w = weights[:, :-1].detach() + 1e-5
    u = uniform((b, n_fine), z, u, generator)
    inds = torch.clamp(_inverse_cdf(w, u) - 1, 0, k - 2)
    z_lo = torch.gather(z, 1, inds)
    z_hi = torch.gather(z, 1, inds + 1)
    t = uniform((b, n_fine), z, t, generator)
    return z_lo + t * (z_hi - z_lo)


def sample_fine_depth(rays: torch.Tensor, depth: torch.Tensor,
                      n_fine_depth: int, depth_std: float = 0.001,
                      eps: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Gaussian samples around a per-ray depth, clamped to [near, far].
    rays: (B, 8); depth: (B,); eps: (B, n_fine_depth) standard normal."""
    shape = (rays.shape[0], n_fine_depth)
    if eps is None:
        eps = normal(shape, rays, generator)
    z = depth[:, None].expand(shape) + eps.to(rays) * depth_std
    return torch.minimum(torch.maximum(z, rays[:, -2:-1]), rays[:, -1:])
