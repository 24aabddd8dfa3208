"""3-D spatial soft-argmax keypoints (counterpart of the JAX package's
`ops/spatial_softmax.py`).

Per-channel softmax over the flattened volume at temperature 0.01, then the
expected position in [-1, 1]. The position grids follow the reference's
np.meshgrid(linspace(D), linspace(H), linspace(W)) default 'xy' indexing:
for a feature at (z, y, x) of a cubic volume the three weights are
lin[y], lin[z], lin[x].
"""
from __future__ import annotations

import torch


def _pos_grids(d: int, h: int, w: int, device, dtype=torch.float32):
    """The reference's np.meshgrid grids, built on `device` in fp64 (as
    numpy builds them) and rounded to `dtype`: a grid built on the host
    would be made and copied to the device on every call."""
    lin = [torch.linspace(-1.0, 1.0, n, dtype=torch.float64, device=device)
           for n in (d, h, w)]
    return tuple(p.reshape(-1).to(dtype)
                 for p in torch.meshgrid(*lin, indexing="xy"))


def spatial_softmax_3d(feature: torch.Tensor,
                       temperature: float = 0.01) -> torch.Tensor:
    """feature: (B, D, H, W, C) channel-last -> (B, 3C) expected keypoints.

    As in JAX, the max is subtracted in the feature's dtype and the
    difference is then taken to fp32 (float64 stays float64) for the exp.
    """
    b, d, h, w, c = feature.shape
    wide = torch.promote_types(feature.dtype, torch.float32)
    px, py, pz = _pos_grids(d, h, w, feature.device, wide)
    basis = torch.stack([torch.ones_like(px), px, py, pz], dim=-1)   # (DHW, 4)
    m = torch.amax(feature, dim=(1, 2, 3), keepdim=True)
    e = torch.exp((feature - m).to(wide) / temperature)
    sums = torch.einsum("bnc,nk->bck", e.reshape(b, d * h * w, c), basis)
    kp = sums[..., 1:] / sums[..., :1]
    return kp.reshape(b, c * 3)
