"""NeRF alpha compositing along rays (counterpart of the JAX package's
`ops/compositing.py`).

Transmittance is the exclusive cumsum of the optical depth
x = delta * relu(sigma) in log space, T_i = exp(-sum_{j<i} x_j): exactly
prod(1 - alpha_j), without the cumprod(1 - alpha + 1e-10) form whose
backward has a gradient cliff once fp32 rounds a saturated alpha to 1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CompositeOut(NamedTuple):
    weights: torch.Tensor   # (B, K)
    rgb: torch.Tensor       # (B, 3)
    embed: torch.Tensor     # (B, D)
    depth: torch.Tensor     # (B,)


def compute_weights(z_sorted: torch.Tensor, sigmas_sorted: torch.Tensor,
                    rays: torch.Tensor) -> torch.Tensor:
    """Compositing weights from SORTED depths and their sigmas."""
    deltas = torch.cat([z_sorted[:, 1:] - z_sorted[:, :-1],
                        rays[:, -1:] - z_sorted[:, -1:]], dim=-1)
    x = deltas * torch.relu(sigmas_sorted)
    alphas = 1.0 - torch.exp(-x)
    log_t = torch.cumsum(x, dim=-1) - x
    return alphas * torch.exp(-log_t)


def composite(z_samp: torch.Tensor, rays: torch.Tensor, rgbs: torch.Tensor,
              sigmas: torch.Tensor, embeds: torch.Tensor,
              white_bkgd: bool = False) -> CompositeOut:
    """z_samp: (B, K) sorted; rays: (B, 8); rgbs: (B, K, 3); sigmas: (B, K);
    embeds: (B, K, D)."""
    weights = compute_weights(z_samp, sigmas, rays)
    rgb = (weights[..., None] * rgbs).sum(dim=-2)
    embed = (weights[..., None] * embeds).sum(dim=-2)
    depth = (weights * z_samp).sum(dim=-1)
    if white_bkgd:
        rgb = rgb + (1.0 - weights.sum(dim=1)[..., None])
    return CompositeOut(weights=weights, rgb=rgb, embed=embed, depth=depth)


def compute_weights_unsorted(z_samp: torch.Tensor, sigmas: torch.Tensor,
                             rays: torch.Tensor) -> torch.Tensor:
    """Compositing weights for samples in ARBITRARY order, without sorting:
    the successor depth is a masked min and the transmittance a masked
    matmul over the predecessor mask M_ij = [z_j < z_i or (z_j == z_i and
    j < i)] (stable-argsort ties). Weights come back in the input order."""
    b, k = z_samp.shape
    idx = torch.arange(k, device=z_samp.device)
    zi = z_samp[:, :, None]
    zj = z_samp[:, None, :]
    before = (zj < zi) | ((zj == zi) & (idx[None, :, None] > idx[None, None, :]))
    after = (zj > zi) | ((zj == zi) & (idx[None, :, None] < idx[None, None, :]))
    big = rays[:, -1:][..., None].expand(b, k, k)
    succ_z = torch.where(after, zj.expand(b, k, k), big).amin(dim=-1)
    x = (succ_z - z_samp) * torch.relu(sigmas)
    alphas = 1.0 - torch.exp(-x)
    transmittance = torch.exp(-torch.einsum("bij,bj->bi", before.to(x.dtype), x))
    return alphas * transmittance


def composite_unsorted(z_samp: torch.Tensor, rays: torch.Tensor,
                       rgbs: torch.Tensor, sigmas: torch.Tensor,
                       embeds: torch.Tensor,
                       white_bkgd: bool = False) -> CompositeOut:
    """Composite samples given in ARBITRARY depth order: only the weights
    depend on the order, and compute_weights_unsorted finds them without
    sorting, so the wide rgb and embed rows are never reordered. Weights
    come back in the input sample order."""
    weights = compute_weights_unsorted(z_samp, sigmas, rays)
    rgb = (weights[..., None] * rgbs).sum(dim=-2)
    embed = (weights[..., None] * embeds).sum(dim=-2)
    depth = (weights * z_samp).sum(dim=-1)
    if white_bkgd:
        rgb = rgb + (1.0 - weights.sum(dim=1)[..., None])
    return CompositeOut(weights=weights, rgb=rgb, embed=embed, depth=depth)
