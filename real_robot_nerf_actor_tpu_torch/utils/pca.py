"""PCA of teacher feature maps (counterpart of the JAX package's
`utils/pca.py`): when a renderer's d_embed is below the teacher's width,
the (N, D) teacher features are reduced to d_embed components.

The fit is an eigendecomposition of the (D, D) covariance (descending
eigenvalues); each component's sign follows sklearn's svd_flip (its
largest-|coefficient| entry positive), so projections compare across fits.
"""
from __future__ import annotations

import torch


def pca_fit(x: torch.Tensor, n_components: int):
    """x: (N, D). Returns (components (k, D), mean (D,), explained
    variance (k,)), in fp32."""
    n = x.shape[0]
    mean = x.mean(dim=0)
    xc = (x - mean).to(torch.float32)
    evals, evecs = torch.linalg.eigh(xc.T @ xc / (n - 1))     # ascending
    comps = evecs.flip(-1)[:, :n_components].T
    var = evals.flip(-1)[:n_components]
    idx = comps.abs().argmax(dim=1)
    signs = torch.sign(comps[torch.arange(n_components, device=x.device), idx])
    return comps * signs[:, None], mean, var


def pca_transform(x: torch.Tensor, components: torch.Tensor,
                  mean: torch.Tensor) -> torch.Tensor:
    """Project (..., D) features onto (k, D) components -> (..., k)."""
    flat = x.reshape(-1, x.shape[-1])
    out = (flat - mean).to(torch.float32) @ components.T
    return out.reshape(*x.shape[:-1], components.shape[0])


def pca_fit_transform(x: torch.Tensor, n_components: int) -> torch.Tensor:
    """sklearn PCA(n).fit_transform of (..., D) feature maps: fit on every
    vector, return (..., n)."""
    flat = x.reshape(-1, x.shape[-1])
    comps, mean, _ = pca_fit(flat, n_components)
    return pca_transform(flat, comps, mean).reshape(*x.shape[:-1], n_components)
